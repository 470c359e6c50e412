#!/usr/bin/env python3
"""The fused ring between two processes on one card, through CUDA IPC.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_ring_ipc.py

Two processes, ranks 0 and 1 of a gloo group over a FileStore, both on
cuda:0, each holding half of an N = 16384 state (masses from [0.5, 2], the
last 77 bodies zero-mass at the origin). Each opens its side of the fused
ring as a mesh does (``parallel.sharded.open_fused_ring``: the handles
gathered, the peer's region mapped with cudaIpcOpenMemHandle, a barrier),
calls the ring kernel `CALLS` times and holds every result to the
hop-ordered sum of force-kernel launches on its own card, bit for bit. The
two processes' kernels share the card by time slices, so a hop waits for
the other process's turn; the wall time of each call is printed. Exits 0
when both ranks' results are equal.
"""

from __future__ import annotations

import datetime
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N = 16384
SOFT = 0.1
CALLS = 5


def rank_main(rank: int, store: str, results) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from nbody_tpu_torch import NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.parallel.mesh import Mesh
    from nbody_tpu_torch.parallel.sharded import open_fused_ring

    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        pos, _ = ic.generate(NBodyConfig.SHELL, N, *tuned_scales(N), seed=42)
        rng = np.random.default_rng(42)
        pos[:, 3] = rng.uniform(0.5, 2.0, N)
        pos[-77:] = 0.0
        shards = [torch.tensor(s, device=dev) for s in np.split(pos, 2)]
        mesh = Mesh(axis="bodies", size=2, rank=rank, group=dist.group.WORLD, device=dev)
        ring = open_fused_ring(mesh, N // 2, ck.DEFAULT_BLOCK_SIZE)
        want = torch.add(ck.compute_accel_cuda(shards[rank], shards[rank], SOFT),
                         ck.compute_accel_cuda(shards[rank], shards[1 - rank], SOFT))
        walls, same = [], True
        for _ in range(CALLS):
            t0 = time.perf_counter()
            got = ck.ring_accel_fused_cuda(shards[rank], SOFT, ring)
            walls.append(time.perf_counter() - t0)
            same = same and bool(torch.equal(got, want))
        ring.close()
        results.put((rank, same, walls, None))
    except Exception as e:  # reported by the parent, which fails with it
        results.put((rank, False, [], f"{type(e).__name__}: {e}"))
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=rank_main, args=(r, str(pathlib.Path(tmp) / "store"),
                                                    results)) for r in range(2)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in range(2):
                rank, same, walls, err = results.get(timeout=180)
                got[rank] = (same, walls, err)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    ok = len(got) == 2
    for rank in sorted(got):
        same, walls, err = got[rank]
        print(f"ipc rank {rank}: bit-equal to hop-ordered accel launches {same}; wall s a call "
              f"{', '.join(f'{w:.4f}' for w in walls)}" + (f"; error {err}" if err else ""))
        ok = ok and same and err is None
    print(f"ipc two processes on one card: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
