"""The MSM pipeline's rounds of bucket accumulation per step: the program's
own count (`msm.ROUNDS`, the largest bucket segment of each pipeline run)
over the window's steps."""


def read(ctx):
    return ctx["rounds"] / ctx["steps"] if ctx["rounds"] else None
