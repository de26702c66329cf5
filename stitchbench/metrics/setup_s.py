"""Seconds from the process's start to the first timed job: imports,
kernel load (a build on a checkout's first run), inputs, warm-up."""


def read(rec):
    return rec["setup_s"]
