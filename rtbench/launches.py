"""The program's own launch counters (program_counter): the packet
kernel's launches by variant and the stream3 kernels' by stage, as the
port's wrappers count them (ops/cuda_build.count_launch)."""


def _mods():
    from radiance_tpu_torch.ops import packet_trace, stream3_stages
    return packet_trace, stream3_stages


def reset():
    pk, stg = _mods()
    pk.packet_trace_cuda.launches.clear()
    stg.reset_launches()


def counts():
    pk, stg = _mods()
    out = {f"packet[{k}]": v for k, v in pk.packet_trace_cuda.launches.items()}
    out.update({k: fn.launches for k, fn in stg.KERNELS.items()})
    return out


def lost_records(recs):
    """Launches of the packet kernel and of kernel B that have no device
    record in a profile (each launch makes one record)."""
    pk, stg = _mods()
    want = sum(pk.packet_trace_cuda.launches.values())
    emit = stg.KERNELS["emit"].launches
    got_pk = sum(1 for r in recs if "packet_trace_kernel" in r[0])
    got_emit = sum(1 for r in recs if "emit_window_kernel" in r[0])
    return max(want - got_pk, 0) + max(emit - got_emit, 0)
