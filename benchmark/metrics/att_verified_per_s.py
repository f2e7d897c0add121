"""att_verified_per_s: attestations whose verdict the window resolved, over
the window's seconds, from the first submit to the last flush's return
(host clock)."""


def read(f):
    return f.verdicts / f.window_s if f.window_s > 0 else None
