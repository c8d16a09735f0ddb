"""packet.secondary_ms.waves: CUDA events around each iteration's bounce
and shadow calls (packet_trace.trace_rays_packet, live-masked) in the
traced window, mean ms."""


def read(run):
    ms = run.event_ms("secondary")
    return sum(ms) / len(ms) if ms else None
