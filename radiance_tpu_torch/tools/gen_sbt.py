"""SBT code generator: sbt.json -> Python dispatch module.

Equivalent of the reference's genSBT.py (reference: tools/genSBT.py),
which appends generated callHit/callMiss switch functions to an OpenCL
shader.  Here the generated artifact is a Python module that builds a
ShaderBindingTable wired to a shader registry, with the same record-index
dispatch keys (hit: instanceSBTOffset + sbtRecordOffset; miss: missIndex).

Port of radiance_tpu/tools/gen_sbt.py: the generated module builds the
port's ShaderBindingTable.

Usage:
    python -m radiance_tpu_torch.tools.gen_sbt samples/sbt.json -o my_sbt.py
"""

from __future__ import annotations

import argparse
import json

TEMPLATE = '''"""Generated by radiance_tpu_torch.tools.gen_sbt -- do not edit.

Dispatch table for the shader binding records below; pair it with a
registry mapping shader names to callables:

{table_doc}
"""

from radiance_tpu_torch.api.sbt import ShaderBindingTable

RECORDS = {records}

REQUIRED_SHADERS = {required}


def build(shader_registry):
    """shader_registry: dict name -> callable(ctx, payload) -> payload."""
    missing = [n for n in REQUIRED_SHADERS if n not in shader_registry]
    if missing:
        raise KeyError(f"shader registry missing: {{missing}}")
    return ShaderBindingTable.from_json(RECORDS, shader_registry)
'''


def generate(records: list) -> str:
    lines = []
    required = set()
    for i, r in enumerate(records):
        parts = []
        for kind in ("raygen", "closestHit", "anyHit", "miss"):
            name = r.get(kind, "")
            if name:
                parts.append(f"{kind}={name}")
                if kind != "raygen":
                    required.add(name)
        lines.append(f"  record {i}: {', '.join(parts) or '(empty)'}")
    return TEMPLATE.format(
        table_doc="\n".join(lines),
        records=json.dumps(records, indent=4),
        required=sorted(required))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sbt_json")
    ap.add_argument("-o", "--output", default="sbt_generated.py")
    args = ap.parse_args()

    with open(args.sbt_json) as f:
        records = json.load(f)

    for i, r in enumerate(records):
        print(f"1. raygen : {r.get('raygen', '')}  "
              f"2. closestHit: {r.get('closestHit', '')}  "
              f"3. anyHit: {r.get('anyHit', '')}  "
              f"4. miss: {r.get('miss', '')}")

    code = generate(records)
    with open(args.output, "w") as f:
        f.write(code)
    print(f"The generated dispatch module has been written to {args.output}.")


if __name__ == "__main__":
    main()
