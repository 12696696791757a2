"""setup_s: seconds from the process's start to the end of set-up (host clock)."""


def read(r):
    return r.setup_s
