"""Mean host ms from the call into ``engine.logits`` to its return, with every
launch of the forward enqueued, over the traced run's window."""


def read(r):
    return 1e3 * sum(r.host_s) / len(r.host_s) if r.host_s else None
