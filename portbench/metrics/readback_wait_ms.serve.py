"""The main thread's wait for read-backs (the program's
``host/readback_wait`` span of ``infer/pipeline.py::GroupPipeline``) in ms
a frame served in the window."""


def read(run):
    span = run.spans.get("host/readback_wait")
    if span is None or not run.counts.get("frames"):
        return None
    return span["ms"] / run.counts["frames"]
