#!/usr/bin/env python3
"""Time the port's row kernels (`gather_rows`, `scatter_rows`) of one
checkout at the top-K group gather's shapes, on one NVIDIA GPU.

    python tools/torch_rows_ab.py <checkout>

Imports `chip_smoke.py` and `ngf_tpu_torch` of <checkout> (this tree, or a
parent unpacked with `git archive`), builds its kernels and runs its
``chip_smoke.group_gather_rows`` (each kernel against its plain version byte
for byte, timed by CUDA events and in a CUDA graph beside its bound and the
library call) on synthetic payloads and picks of the paths' shapes: the
fused features of the staged recipe's masked step at ``--rgb_cap 64``
((4096, 28 x 8, 216) float32 and bfloat16, 8 of 28 groups a ray), the smoke
recipe's coordinates ((1024, 64 x 8, 6), 8 of 64) and the dense path's
group-1 coordinates ((4096, 512, 6), the top 64 samples of random weights).
Then the batch gather's device time at 4096 ids of a (491520, 6) and a
(491520, 9) table (torch.profiler). Prints one line ``AB {json}``. To compare
two checkouts on one card, run them in one call: parent, change, change,
parent.
"""

import json
import os
import sys


def main() -> None:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as c
    from ngf_tpu_torch.ops import cuda_kernels

    if not torch.cuda.is_available():
        sys.exit("torch_rows_ab: needs a CUDA device")
    cuda_kernels.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(c.SEED)

    def picks(n, ng, k):
        return torch.rand((n, ng), generator=gen, device=dev).argsort(dim=1)[:, :k]

    rows = []
    fused = torch.randn((4096, 28 * 8, 216), generator=gen, device=dev)
    idx = picks(4096, 28, 8)
    rows += c.group_gather_rows("fused f32", fused, idx, 8)
    rows += c.group_gather_rows("fused bf16", fused.to(torch.bfloat16), idx, 8)
    del fused
    smoke = torch.randn((1024, 64 * 8, 6), generator=gen, device=dev)
    rows += c.group_gather_rows("smoke coords", smoke, picks(1024, 64, 8), 8)
    coords = torch.rand((4096, 512, 6), generator=gen, device=dev) * 2 - 1
    w = torch.rand((4096, 512), generator=gen, device=dev)
    rows += c.group_gather_rows("dense coords", coords, torch.topk(w, 64, dim=1).indices, 1)
    ids = torch.randperm(491520, generator=gen, device=dev)[:4096]
    batch = {}
    for d in (6, 9):
        tab = torch.randn((491520, d), generator=gen, device=dev)
        batch[f"table (491520, {d})"] = c.kernel_device_ms(
            lambda: cuda_kernels.gather_rows(tab, ids), "gather_rows_kernel")
    keys = ("kernel", "case", "ms", "graph_ms", "bound_ms", "library_ms", "plain_ms")
    out = {"tree": sys.argv[1], "card": c.card_line(), "batch_device_ms": batch,
           "rows": [{k: r[k] for k in keys} | {"lane": r.get("lane_bytes"),
                                               "route": r.get("route")} for r in rows]}
    print("AB " + json.dumps(out))


if __name__ == "__main__":
    main()
