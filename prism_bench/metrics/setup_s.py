"""Set-up time: process start to the window's start (weights, kernel load or
build, the graph ladder, prompts and the traffic warm-up)."""


def read(run):
    return run.setup_s
