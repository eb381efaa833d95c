"""The card's idle time inside the MSM pipeline's round loop, in % of one
step under torch.profiler (`idle_in_rounds_pct.prove`, `.msm_batch` and
`.msm_single`, one per rate they move): the idle gaps that began while the
host was in the program's `msm/rounds` stage, over the traced step's wall
time. How far the round loop's launches, not the card, set the pace.
Nothing to read where the step ran no device operation, or where the
program has no such stage."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device_ops or not any(name == "msm/rounds" for name, _, _ in tr.ranges):
        return None
    return 100.0 * tr.idle_by_range().get("msm/rounds", 0.0) / tr.window_s
