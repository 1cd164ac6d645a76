"""The batched asset pipeline and the device mesh: texcomp_torch.dist
against texcomp.dist on the CPU.

The same numpy inputs go through both packages: texcomp runs its own CPU
path, the port its plain twins (``device="cpu"``). Payloads and Metadata
must be equal byte for byte; PSNRs agree within 1e-3 dB (texcomp sums its
squared error in float32, the port exactly in int64). A port mesh is a
list of CPU devices, repeated, as texcomp's tests use 8 virtual CPU
devices. quality="high" entries are held to the port's own per-asset API
byte for byte, and to texcomp at 16x16, where texcomp's jitted bytes equal
its op-by-op ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import texcomp
import texcomp_torch
from texcomp import ops as jops
from texcomp.dist import mesh as jmesh
from texcomp.dist import pipeline as jpipe
from texcomp_torch import ops as tops
from texcomp_torch.api.container import Format
from texcomp_torch.dist import mesh as tmesh
from texcomp_torch.dist import pipeline as tpipe
from tests.conftest import make_test_image

CPU = torch.device("cpu")
CHANNELS = {"dxt1": 3, "etc1": 3, "dxt5": 4, "pvrtc": 4, "pvrtc4": 4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small eager ops: one intra-op thread keeps test workers that share
    the cores from stalling each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(data: int, block: int = 1) -> tmesh.Mesh:
    return tmesh.make_mesh(data * block, data=data, block=block,
                           devices=[CPU] * (data * block))


def jax_fmt(fmt):
    return None if fmt is None else texcomp.Format(int(fmt))


def images_of(seed: int, b: int, h: int, w: int, c: int,
              solid_first: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    imgs = np.stack([make_test_image(rng, h, w, c) for _ in range(b)])
    if solid_first:
        # A solid image reaches the const-colour path, where the BGR
        # double swap lives (dxtc_compressor.cc:360).
        imgs[0] = make_test_image(rng, h, w, c, kind="solid")
    return imgs


def assert_same(got, want, name=""):
    """Port CompressedImage against texcomp's: payload and metadata."""
    np.testing.assert_array_equal(np.asarray(got.get_data()),
                                  np.asarray(want.get_data()), err_msg=name)
    g, w = got.get_metadata(), want.get_metadata()
    assert (int(g.format), g.compressor_name, g.uncompressed_height,
            g.uncompressed_width, g.compressed_height, g.compressed_width,
            g.padding_bytes_per_row) == (
        int(w.format), w.compressor_name, w.uncompressed_height,
        w.uncompressed_width, w.compressed_height, w.compressed_width,
        w.padding_bytes_per_row), name


# ---------------------------------------------------------------------------
# The op facade.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_etc1_encode_image_op(strategy):
    img = images_of(1, 1, 16, 24, 3)[0]
    got = tops.etc1_encode_image_op(torch.from_numpy(img), strategy)
    want = jops.etc1_encode_image_op(jnp.asarray(img), strategy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_etc1_decode_image_op():
    """The port decodes to (H, W, 4) RGBX; texcomp's CPU op gives (N, 16,
    3) blocks, which the test lays out as the image."""
    h, w = 12, 20
    img = images_of(2, 1, h, w, 3)[0]
    enc = np.asarray(jops.etc1_encode_image_op(jnp.asarray(img), 2))
    rand = np.random.default_rng(3).integers(0, 256, enc.shape, np.uint8)
    for data in (enc, rand):
        got = tops.etc1_decode_image_op(torch.from_numpy(data.copy()), h,
                                        w).numpy()
        want = np.asarray(jops.etc1_decode_image_op(jnp.asarray(data), h, w))
        want = (want.reshape(h // 4, w // 4, 4, 4, 3).transpose(0, 2, 1, 3, 4)
                .reshape(h, w, 3))
        np.testing.assert_array_equal(got[..., :3], want)
        assert not got[..., 3].any()


@pytest.mark.parametrize("side", [8, 16, 32])
def test_pvrtc_encode_image_op(side):
    img = images_of(side, 1, side, side, 4)[0]
    got = tops.pvrtc_encode_image_op(torch.from_numpy(img))
    want = jops.pvrtc_encode_image_op(jnp.asarray(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# _batch_encode: the tall fold against texcomp's batched encode.
# ---------------------------------------------------------------------------

BATCH_CASES = [
    # codec, format, strategy, batch, height, width
    ("dxt1", Format.RGB, 2, 5, 8, 12),
    ("dxt1", Format.BGR, 2, 3, 16, 16),
    ("dxt1", Format.RGB, 2, 1, 64, 64),
    ("dxt5", Format.RGBA, 2, 4, 12, 20),
    ("dxt5", Format.BGRA, 2, 2, 32, 32),
    ("etc1", Format.RGB, 0, 3, 8, 8),
    ("etc1", Format.RGB, 1, 2, 16, 24),
    ("etc1", Format.RGB, 2, 5, 16, 16),
    ("etc1", Format.RGB, 3, 1, 32, 32),
    ("pvrtc", Format.RGBA, 2, 3, 16, 16),
    ("pvrtc", Format.RGBA, 2, 1, 64, 64),
    ("pvrtc4", Format.RGBA, 2, 2, 16, 16),
]


@pytest.mark.parametrize("codec,fmt,strategy,b,h,w", BATCH_CASES)
def test_batch_encode(codec, fmt, strategy, b, h, w):
    swap = fmt in (Format.BGR, Format.BGRA)
    imgs = images_of(b * h + w, b, h, w, CHANNELS[codec], solid_first=True)
    got = tpipe._batch_encode(torch.from_numpy(imgs), codec, strategy,
                              swap=swap)
    want = jpipe._batch_encode(jnp.asarray(imgs), codec, strategy, swap=swap)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _api_encode(codec: str, img: np.ndarray, fmt: Format,
                quality: str) -> np.ndarray:
    """The port's per-asset compress of one image."""
    comp = {"dxt1": texcomp_torch.DxtcCompressor,
            "dxt5": texcomp_torch.DxtcCompressor,
            "etc1": texcomp_torch.EtcCompressor,
            "pvrtc": texcomp_torch.PvrtcCompressor,
            "pvrtc4": texcomp_torch.Pvrtc4bppCompressor}[codec](
        quality=quality, device="cpu")
    ci = texcomp_torch.CompressedImage()
    h, w = img.shape[:2]
    assert comp.compress(fmt, h, w, 0, img.tobytes(), ci)
    return np.asarray(ci.get_data())


@pytest.mark.parametrize("codec", ["dxt1", "dxt5", "etc1", "pvrtc", "pvrtc4"])
def test_batch_encode_hq(codec):
    """quality="high": the flattened block batch (or the per-image PVRTC
    encode) equals the per-asset API and texcomp's batched HQ encode."""
    imgs = images_of(40 + len(codec), 2, 16, 16, CHANNELS[codec])
    got = tpipe._batch_encode(torch.from_numpy(imgs), codec, 2,
                              quality="high").numpy()
    fmt = tpipe._FORMATS[codec]
    for i in range(len(imgs)):
        np.testing.assert_array_equal(
            got[i].reshape(-1), _api_encode(codec, imgs[i], fmt, "high"))
    want = jpipe._batch_encode(jnp.asarray(imgs), codec, 2, quality="high")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("codec,fmt", [("dxt1", Format.BGR),
                                       ("dxt5", Format.BGRA)])
def test_batch_encode_hq_swapped(codec, fmt):
    imgs = images_of(50, 2, 8, 12, CHANNELS[codec], solid_first=True)
    got = tpipe._batch_encode(torch.from_numpy(imgs), codec, 2,
                              quality="high", swap=True).numpy()
    for i in range(len(imgs)):
        np.testing.assert_array_equal(
            got[i].reshape(-1), _api_encode(codec, imgs[i], fmt, "high"))


# ---------------------------------------------------------------------------
# AssetPipeline.run against texcomp's.
# ---------------------------------------------------------------------------

FLEET_SPECS = [
    # codec, height, width, format (None: the codec's default), strategy
    ("dxt1", 8, 8, None, 2),
    ("dxt1", 12, 20, Format.BGR, 2),
    ("dxt1", 24, 24, Format.RGB, 2),  # explicit RGB is IntEnum 0
    ("dxt5", 8, 8, Format.BGRA, 2),
    ("dxt5", 16, 12, Format.RGBA, 2),
    ("etc1", 8, 8, None, 2),
    ("etc1", 12, 20, None, 0),
    ("etc1", 16, 32, None, 1),
    ("pvrtc", 16, 16, None, 2),
    ("pvrtc", 32, 32, None, 2),
    ("pvrtc4", 8, 8, None, 2),
    ("dxt5", 4, 8, Format.BGRA, 2),
    ("etc1", 8, 4, None, 3),
]


def fleet_assets(package) -> list:
    """The same mixed fleet of 39 assets as texcomp or port assets."""
    rng = np.random.default_rng(77)
    assets = []
    for k in range(3):
        for i, (codec, h, w, fmt, strategy) in enumerate(FLEET_SPECS):
            kind = "solid" if (i + k) % 3 == 0 else "mixed"
            img = make_test_image(rng, h, w, CHANNELS[codec], kind=kind)
            if package is texcomp:
                assets.append(jpipe.TextureAsset(
                    f"{codec}_{h}x{w}_{i}_{k}", img, codec, strategy,
                    format=jax_fmt(fmt)))
            else:
                assets.append(tpipe.TextureAsset(
                    f"{codec}_{h}x{w}_{i}_{k}", img, codec, strategy,
                    format=fmt))
    return assets


@pytest.fixture(scope="module")
def texcomp_fleet():
    """texcomp's run(mipmaps=True) of the fleet, on one CPU device."""
    return jpipe.AssetPipeline(batch_size=4).run(fleet_assets(texcomp),
                                                 mipmaps=True)


def test_run_payloads_and_metadata(texcomp_fleet):
    got = tpipe.AssetPipeline(batch_size=4, device="cpu").run(
        fleet_assets(texcomp_torch))
    assets = fleet_assets(texcomp_torch)
    assert set(got) == {a.name for a in assets}
    for a in assets:
        assert_same(got[a.name], texcomp_fleet[a.name], a.name)
    # The explicit RGB stays RGB.
    assert got["dxt1_24x24_2_0"].get_metadata().format == Format.RGB


def test_run_mipmaps(texcomp_fleet):
    """Every _mipN entry equals texcomp's, payload and metadata: a fused
    prefix and a ragged tail (8x8, 16x32), a fused level alone (24x24), a
    tail alone (4x8, 8x4) and no level (12x20, 3 block rows)."""
    got = tpipe.AssetPipeline(batch_size=4, device="cpu").run(
        fleet_assets(texcomp_torch), mipmaps=True)
    assert set(got) == set(texcomp_fleet)
    for name in ("dxt1_8x8_0_0_mip3", "etc1_16x32_7_0_mip5",
                 "dxt1_24x24_2_0_mip1", "dxt5_4x8_11_2_mip3",
                 "etc1_8x4_12_1_mip3"):
        assert name in got
    for name in ("dxt1_8x8_0_0_mip4", "dxt1_24x24_2_0_mip2",
                 "dxt1_12x20_1_0_mip1"):
        assert name not in got
    assert not any(n.startswith("pvrtc") and "_mip" in n for n in got)
    for name, ci in got.items():
        assert_same(ci, texcomp_fleet[name], name)


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
def test_run_shard_invariance(ndev, texcomp_fleet):
    """Meshes of 1, 2, 3 and 8 CPU devices give texcomp's bytes."""
    got = tpipe.AssetPipeline(cpu_mesh(ndev), batch_size=4).run(
        fleet_assets(texcomp_torch), mipmaps=True)
    assert set(got) == set(texcomp_fleet)
    for name, ci in got.items():
        assert_same(ci, texcomp_fleet[name], name)


@pytest.mark.parametrize("max_inflight,batch_size",
                         [(2, 1), (8, 1), (2, 64), (8, 64)])
def test_run_window_invariance(max_inflight, batch_size, texcomp_fleet):
    got = tpipe.AssetPipeline(batch_size=batch_size,
                              max_inflight=max_inflight,
                              device="cpu").run(fleet_assets(texcomp_torch))
    assert set(got) == {a.name for a in fleet_assets(texcomp_torch)}
    for name, ci in got.items():
        assert_same(ci, texcomp_fleet[name], name)


def test_run_mixed_quality():
    """quality="high" assets beside reference ones: the HQ entries equal
    the per-asset API, and so do their mip chains."""
    rng = np.random.default_rng(91)
    assets, imgs = [], {}
    for codec in ("dxt1", "dxt5", "etc1", "pvrtc", "pvrtc4"):
        for q in ("reference", "high"):
            for i in range(2):
                name = f"{codec}_{q}_{i}"
                imgs[name] = make_test_image(rng, 16, 16, CHANNELS[codec])
                assets.append(tpipe.TextureAsset(name, imgs[name], codec,
                                                 quality=q))
    got = tpipe.AssetPipeline(cpu_mesh(2)).run(assets, mipmaps=True)
    for a in assets:
        fmt = tpipe._FORMATS[a.codec]
        np.testing.assert_array_equal(
            got[a.name].get_data(),
            _api_encode(a.codec, imgs[a.name], fmt, a.quality), a.name)
    chain = texcomp_torch.DxtcCompressor(quality="high", device="cpu") \
        .downsample_chain(got["dxt5_high_0"])
    assert len(chain) == 4
    for lvl, mip in enumerate(chain, start=1):
        np.testing.assert_array_equal(got[f"dxt5_high_0_mip{lvl}"].get_data(),
                                      mip.get_data())


def test_invalid_formats_raise():
    """Format/codec mismatches fail loudly with texcomp's message; an
    explicit Format.RGB (IntEnum 0) is validated, not replaced."""
    p = tpipe.AssetPipeline(device="cpu")
    rng = np.random.default_rng(5)
    with pytest.raises(ValueError, match="cannot encode"):
        p.encode_group(np.stack([make_test_image(rng, 8, 8, 3)]), "etc1",
                       fmt=Format.BGR)
    with pytest.raises(ValueError, match="cannot encode"):
        p.encode_group(np.stack([make_test_image(rng, 8, 8, 4)]), "pvrtc",
                       fmt=Format.BGRA)
    bad = tpipe.TextureAsset("bad", make_test_image(rng, 8, 8, 4), "dxt5",
                             format=Format.RGB)
    with pytest.raises(ValueError, match="cannot encode"):
        p.run([bad])


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(9, data=9, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="positive"):
        tmesh.make_mesh(4, data=0, block=1, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.Mesh([], ("data",))
    mesh = cpu_mesh(4, 2)
    assert mesh.shape == {"data": 4, "block": 2}
    assert len(mesh.data_devices) == 4


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_training_step_multichip(n):
    tmesh.training_step_multichip(n, devices=[CPU] * 8)


def test_training_step_degrades_to_available_devices():
    tmesh.training_step_multichip(16, devices=[CPU] * 8)


def test_step_matches_texcomp():
    """The (data, block) = (4, 2) step: texcomp's payloads, and its PSNR
    within 1e-3 dB."""
    imgs = images_of(61, 4, 32, 32, 3)
    got, psnr = tmesh._step(torch.from_numpy(imgs), cpu_mesh(4, 2))
    jm = JaxMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "block"))
    with jm:
        want, jpsnr = jmesh._step(jnp.asarray(imgs), jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert abs(psnr - float(jpsnr)) < 1e-3


def test_dxt1_pipeline_sharded():
    imgs = images_of(62, 6, 16, 16, 3)
    got = tmesh.dxt1_pipeline_sharded(torch.from_numpy(imgs), cpu_mesh(3))
    want = jmesh.dxt1_encode_batch(jnp.asarray(imgs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ndata", [1, 3, 8])
@pytest.mark.parametrize("codec", ["dxt1", "dxt5", "etc1"])
def test_encode_atlas_sharded(codec, ndata):
    """Strips on 1, 3 and 8 devices give the one-device op's blocks, and
    texcomp's."""
    img = images_of(63, 1, 96, 40, CHANNELS[codec])[0]
    got = tmesh.encode_atlas_sharded(torch.from_numpy(img), cpu_mesh(ndata),
                                     codec, strategy=1)
    t = torch.from_numpy(img)
    one = {"dxt1": tops.dxt1_encode_image_op, "dxt5": tops.dxt5_encode_image_op,
           "etc1": lambda x: tops.etc1_encode_image_op(x, 1)}[codec](t)
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    jop = {"dxt1": jops.dxt1_encode_image_op, "dxt5": jops.dxt5_encode_image_op,
           "etc1": lambda x: jops.etc1_encode_image_op(x, 1)}[codec]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jop(jnp.asarray(img))))


def test_encode_atlas_sharded_errors():
    img = torch.zeros((20, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="4-row multiples"):
        tmesh.encode_atlas_sharded(img, cpu_mesh(2))
    with pytest.raises(ValueError, match="unsupported"):
        tmesh.encode_atlas_sharded(img, cpu_mesh(1), "pvrtc")


# ---------------------------------------------------------------------------
# quality_report.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["dxt1", "dxt5", "etc1", "pvrtc", "pvrtc4"])
def test_quality_report(codec):
    """Within 1e-3 dB of texcomp's; the port's exact sums give the same
    value on a 1- and a 3-device mesh (padding left out)."""
    imgs = images_of(70 + len(codec), 5, 16, 16, CHANNELS[codec])
    one = tpipe.quality_report(tpipe.AssetPipeline(device="cpu"), imgs, codec)
    three = tpipe.quality_report(tpipe.AssetPipeline(cpu_mesh(3)), imgs, codec)
    assert one == three
    want = jpipe.quality_report(jpipe.AssetPipeline(), imgs, codec)
    assert abs(one - want) < 1e-3
