"""Steps the contract loop retried at 4x caps, over the window's steps
(counted from the line the loop prints for each retry)."""


def read(r):
    return r.retried_steps / r.steps if r.steps else None
