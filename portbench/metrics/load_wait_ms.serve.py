"""The main thread's wait for staged frames (the program's ``host/load_wait``
span: decode, erosion, tile placement and upload not done ahead) in ms a
frame served in the window."""


def read(run):
    span = run.spans.get("host/load_wait")
    if span is None or not run.counts.get("frames"):
        return None
    return span["ms"] / run.counts["frames"]
