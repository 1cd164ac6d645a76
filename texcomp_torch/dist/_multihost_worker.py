"""Worker of the two-process pipeline run.

Run as ``python -m texcomp_torch.dist._multihost_worker <pid> <nproc>
<port> <outfile> [fleet] [mipmaps] [--device cpu|cuda]``: joins a gloo
process group on 127.0.0.1:<port>, encodes its round-robin partition of
the shared fleet on ``--device`` (default the card) and writes name ->
payload to ``outfile`` (.npz). :func:`launch_two_process_demo` starts two.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def demo_fleet(seed: int = 7):
    """Deterministic small mixed fleet shared by every process."""
    from texcomp_torch.dist.pipeline import TextureAsset

    rng = np.random.default_rng(seed)
    assets = []
    for size in (16, 32):
        for codec, ch in (("dxt1", 3), ("etc1", 3), ("dxt5", 4),
                          ("pvrtc", 4)):
            for i in range(3):
                img = rng.integers(0, 256, (size, size, ch), dtype=np.uint8)
                assets.append(TextureAsset(f"{codec}_{size}_{i}", img,
                                           codec))
    return assets


def pod_fleet(seed: int = 11):
    """O(200) mixed fleet at 64^2-256^2: every pipeline codec but 4bpp,
    size-skewed like BASELINE config 5, and a quarter of the DXTC assets
    in swapped BGR/BGRA formats so the format routing crosses the process
    boundary too."""
    from texcomp_torch.api.container import Format
    from texcomp_torch.dist.pipeline import TextureAsset

    rng = np.random.default_rng(seed)
    swapped = {"dxt1": Format.BGR, "dxt5": Format.BGRA}
    assets = []
    for size, per in ((64, 36), (128, 12), (256, 4)):
        for codec, ch in (("dxt1", 3), ("etc1", 3), ("dxt5", 4),
                          ("pvrtc", 4)):
            for i in range(per):
                img = rng.integers(0, 256, (size, size, ch), dtype=np.uint8)
                fmt = (swapped[codec]
                       if codec in swapped and i % 4 == 3 else None)
                assets.append(TextureAsset(f"{codec}_{size}_{i}", img,
                                           codec, format=fmt))
    return assets  # 208 assets, ~2.4 Mpix level-0


def quality_batch(seed: int = 13, n: int = 24):
    """Deterministic global image batch for the cross-process PSNR
    (multihost.fleet_quality); identical on every process."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


def launch_two_process_demo(out_paths, repo: str, timeout: float = 600.0,
                            fleet: str = "demo", mipmaps: bool = False,
                            device: str = "cuda"):
    """Start two workers (this module) on a free localhost port and return
    the two loaded result dicts. Kills any worker still running on the way
    out (one stuck in a collective would outlive a communicate()
    timeout)."""
    import os
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [repo, env.get("PYTHONPATH", "")] if p)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"  # two workers beside a test run

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "texcomp_torch.dist._multihost_worker",
             str(p), "2", str(port), str(out_paths[p]), fleet,
             str(int(mipmaps)), "--device", device],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(2)
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost worker failed (rc={p.returncode}):\n"
                f"{log[-2000:]}")
    return [dict(np.load(o)) for o in out_paths]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("pid", type=int)
    parser.add_argument("nproc", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("outfile")
    parser.add_argument("fleet", nargs="?", default="demo",
                        choices=("demo", "pod"))
    parser.add_argument("mipmaps", nargs="?", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from texcomp_torch.dist import multihost

    multihost.initialize(f"127.0.0.1:{args.port}", args.nproc, args.pid)
    try:
        pod = args.fleet == "pod"
        results = multihost.run_fleet(
            pod_fleet() if pod else demo_fleet(),
            mipmaps=bool(args.mipmaps), batch_size=64 if pod else 4,
            device=args.device)
        out = {name: np.asarray(ci.get_data())
               for name, ci in results.items()}
        if pod:
            # Every process must report the SAME global PSNR.
            out["__psnr_dxt1__"] = np.asarray(multihost.fleet_quality(
                quality_batch(), "dxt1", device=args.device))
        np.savez(args.outfile, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
