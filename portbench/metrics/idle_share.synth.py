"""The share of the traced window in which nothing ran on the card, %."""


def read(run):
    return run.trace.idle_share()
