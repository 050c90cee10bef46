"""How many cards work while any does: the device operations' seconds in
the traced window, summed over the cards, over the seconds in which at
least one ran (1 for cards taking turns, the card count for cards that
always work together)."""

from portbench.trace import covered


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    summed = sum(covered([(a, b)], *tr.window) for a, b, _, _ in tr.ops)
    return summed / 1e6 / tr.busy_s
