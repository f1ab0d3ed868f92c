"""Output frames of every request served in the window, each lane up to its own
stop (or the cap), over the window's seconds."""


def read(window):
    return sum(it["frames"] for it in window["items"]) / (window["end"] - window["start"])
