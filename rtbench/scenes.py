"""What both drivers take from a configuration before the program or the
reference sees it: its geometry, made by the generator the configuration
names (rtbench/geometry/<generator>.py), and the plain reference's own
tree over those vertices."""

import numpy as np
import torch

from rtbench import harness
from rtbench.reference import trace as rtrace


def geometry(run):
    """(verts [V, 3] f32, tris [T, 3]) of the configuration, from its
    fixed seed; host clock under the span scene.generate."""
    gen = harness.load_module("geometry", run.cfg["generator"])
    with run.span("scene.generate"):
        return gen.generate(run.cfg["n_tris"], run.cfg["seed"],
                            **run.cfg.get("generator_args", {}))


def reference_tree(run, verts, tris, dtype):
    """reference/trace.py's tree over the triangles, on the run's device,
    every float in `dtype`."""
    tv = torch.from_numpy(verts[tris.astype(np.int64)]).to(run.dev)
    return rtrace.build(tv, dtype)
