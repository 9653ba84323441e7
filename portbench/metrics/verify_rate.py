"""verify_rate: candidates a second over the window's whole launches, from
the verdict instant that opens it to the one that closes it."""


def read(r):
    return r.rate()
