"""bvh.build_s: host clock around the scene build in set-up (the SAH
build, the kernel tables, the upload; for the view cells also the
bindings of assemble_scene)."""


def read(run):
    s = run.span_s("bvh.build")
    return s if s > 0 else None
