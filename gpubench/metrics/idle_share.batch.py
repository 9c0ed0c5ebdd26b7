"""The share of the traced window in which no kernel or copy ran on a card,
in %; on several cards the mean of the cards' shares."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    busy = tr.mean_busy_s(run.devices)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)
