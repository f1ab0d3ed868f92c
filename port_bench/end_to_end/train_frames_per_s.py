"""Valid target frames (the sum of ``target_lengths``) of every step completed in
the window, over the window's seconds."""


def read(window):
    return sum(it["frames"] for it in window["items"]) / (window["end"] - window["start"])
