"""The two-process pipeline run on the CPU: two gloo processes
(texcomp_torch.dist._multihost_worker, ``--device cpu``) encode disjoint
round-robin partitions of one fleet; their union is byte-identical to a
one-process run of the port, and both report the one-process PSNR.
texcomp_torch.dist.multihost against the port's own single-process
pipeline (tests/test_torch_dist.py holds that pipeline to texcomp)."""

import os

import numpy as np
import pytest
import torch

from texcomp_torch.dist import multihost
from texcomp_torch.dist._multihost_worker import (demo_fleet,
                                                  launch_two_process_demo,
                                                  pod_fleet, quality_batch)
from texcomp_torch.dist.pipeline import AssetPipeline, quality_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_process_demo_fleet(tmp_path):
    outs = [str(tmp_path / f"out_{p}.npz") for p in range(2)]
    shards = launch_two_process_demo(outs, REPO, timeout=300.0, device="cpu")
    names0, names1 = set(shards[0]), set(shards[1])
    assert not (names0 & names1), "partitions overlap"
    fleet = demo_fleet()
    assert names0 == {a.name for i, a in enumerate(fleet) if i % 2 == 0}
    assert names1 == {a.name for i, a in enumerate(fleet) if i % 2 == 1}

    single = AssetPipeline(batch_size=4, device="cpu").run(fleet)
    merged = {**shards[0], **shards[1]}
    assert set(merged) == set(single)
    for name, payload in merged.items():
        np.testing.assert_array_equal(payload, single[name].get_data(),
                                      err_msg=name)


def test_two_process_pod_fleet(tmp_path):
    """208 assets at 64^2-256^2 (a quarter of the DXTC assets BGR/BGRA)
    with mipmaps=True over two processes: disjoint partitions, the union
    equal to a one-process run with every mip entry, and both processes'
    fleet PSNR equal to the one-process quality_report."""
    outs = [str(tmp_path / f"pod_{p}.npz") for p in range(2)]
    shards = launch_two_process_demo(outs, REPO, timeout=600.0, fleet="pod",
                                     mipmaps=True, device="cpu")
    psnrs = [float(s.pop("__psnr_dxt1__")) for s in shards]
    assert psnrs[0] == psnrs[1], "processes disagree on the global PSNR"

    names0, names1 = set(shards[0]), set(shards[1])
    assert not (names0 & names1), "partitions overlap"
    assert any(n.endswith("_mip1") for n in names0), "no mip entries"

    single = AssetPipeline(batch_size=64, device="cpu").run(pod_fleet(),
                                                            mipmaps=True)
    merged = {**shards[0], **shards[1]}
    assert set(merged) == set(single)
    for name, payload in merged.items():
        np.testing.assert_array_equal(payload, single[name].get_data(),
                                      err_msg=name)

    ref = quality_report(AssetPipeline(device="cpu"), quality_batch(), "dxt1")
    assert psnrs[0] == ref


def test_single_process_defaults():
    """Outside a process group a process is rank 0 of 1: it takes the
    whole fleet and its fleet PSNR is the quality_report."""
    fleet = demo_fleet()
    assert multihost.partition(fleet) == fleet
    images = quality_batch(n=4)
    assert multihost.fleet_quality(images, "etc1", device="cpu") == \
        quality_report(AssetPipeline(device="cpu"), images, "etc1")
    assert [d.type for d in multihost.local_mesh("cpu").data_devices] == ["cpu"]
