"""Seconds per fit capturing the fused solver's CUDA graphs: the port's
``fused_graph_capture`` stage (0 on the host loop). Nothing when the port
records no ``counters`` event of a ``fit`` span."""


def read(run):
    t = run.trace
    if not any(e["event"] == "counters" and e["span"] == "fit" for e in t.events):
        return None
    return t.totals.get("fused_graph_capture", 0.0) / run.steps
