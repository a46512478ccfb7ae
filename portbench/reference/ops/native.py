"""No native geometry library for the reference: the numpy versions run."""


def available() -> bool:
    return False
