"""Seconds from the start of the process to the window's opening:
loading, building, calibrating, the seeded weights, the captures."""


def read(record):
    return record["setup_s"]
