"""End-to-end readers: ``<name>.py`` has ``read(window)`` over an untraced window
(``items``: each request or step with ``start``, ``end`` and ``frames``;
``start``, ``end``: the window; ``setup_s``)."""
