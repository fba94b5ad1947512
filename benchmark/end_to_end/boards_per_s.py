"""Boards whose FENs came back over the whole window, per second of it: the
window runs from its opening to the end of its last request."""


def read(window) -> float:
    return window.boards / window.seconds
