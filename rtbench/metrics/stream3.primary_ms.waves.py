"""stream3.primary_ms.waves: CUDA events around each primary wave call
(stream3.build_tracer's tracer) in the traced window, mean ms."""


def read(run):
    ms = run.event_ms("primary")
    return sum(ms) / len(ms) if ms else None
