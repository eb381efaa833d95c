"""Host synthesis, milliseconds per transition: the benchmark's span around
each `pipeline.synthesize_and_check` (parse, execute, build the R1CS) over
the window's steps."""


def read(ctx):
    calls = ctx["span_calls"].get("synthesize", 0)
    return ctx["spans"]["synthesize"] / calls * 1e3 if calls else None
