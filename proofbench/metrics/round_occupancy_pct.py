"""The share of the MSM round loop's lane slots that add a point, in %
(`round_occupancy_pct.prove`, `.msm_batch` and `.msm_single`, one per rate
they move): the program's counters `msm/adds` (the points its rounds added)
over `msm/lane_rounds` (lanes, spares included, times rounds) over one step
with the program's profiling on. Nothing to read where the program has no
such counters."""


def read(ctx):
    stages = ctx.get("stages") or {}
    adds, slots = stages.get("count/msm/adds"), stages.get("count/msm/lane_rounds")
    if not adds or not slots or not slots["total"]:
        return None
    return 100.0 * adds["total"] / slots["total"]
