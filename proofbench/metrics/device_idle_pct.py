"""The card's idle share of a step, in % (`device_idle_pct.prove`,
`.msm_batch` and `.msm_single`, one per rate they move): one minus the union of the device's
operations (kernels, copies, fills) in one step under torch.profiler, over
the wall time of the last untraced step of the window, in the same
process."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device_ops or not ctx["untraced_step_s"]:
        return None
    return 100.0 * (1.0 - tr.busy_s() / ctx["untraced_step_s"])
