"""MSMs per bucket pipeline of the commitments (`msms_per_pipeline.prove`):
the program's counters `kzg/msms` (the variable-base MSMs that
`kzg.commit_many_lf` committed) over `kzg/pipelines` (the bucket pipelines
that ran them) over one step with the program's profiling on. 1.0 where a
group's MSMs run one after another, k where a group of k shares one
pipeline. Nothing to read where the program has no such counters."""


def read(ctx):
    stages = ctx.get("stages") or {}
    msms, pipelines = stages.get("count/kzg/msms"), stages.get("count/kzg/pipelines")
    if not msms or not pipelines or not pipelines["total"]:
        return None
    return msms["total"] / pipelines["total"]
