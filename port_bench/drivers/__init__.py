"""Drivers: ``<kind>.py`` runs the program for the traffic generators whose
``KIND`` is ``<kind>``, through a class ``Driver(cell, seed, device)`` with
``warm_up()`` (set-up's traffic; returns the window's first index),
``serve(k)`` (one request or step: a dict with ``frames`` and ``lanes``),
``keep(item)`` (offers a served item to the check's sample), ``samples(after,
count)`` (what the per-layer readers take besides the trace), ``release()``
and ``readings(control)`` (the check's numbers, ``check.py``)."""
