"""``vision_tpu_torch.io.DeviceJpegLoader`` on the CPU against
``vision_tpu.io.tpu_loader.TpuJpegLoader`` on JAX's CPU.

Both loaders visit the samples in the same ``numpy`` order, so they fill
the same buckets in the same order and shard alike. The eval batches are
held to one uint8 level carried through the normalisation (the two
device decodes of the same coefficients differ by one count at most,
``tests/test_torch_jpeg_device.py``; a bilinear crop mixes levels with
weights that sum to one): ``1 / (255 * min(std))``, plus f32 round-off.
The train draws differ by design (Python numbers from a CPU
``torch.Generator`` against ``jax.random`` keys), so the train batches are
held at the boxes and flips that JAX's program draws from its keys,
handed to the port's per-bucket program.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from vision_tpu.io import tpu_loader
from vision_tpu.io.tpu_loader import TpuJpegLoader
from vision_tpu_torch.io import DeviceJpegLoader, encode_png
from vision_tpu_torch.io.device_loader import crop_resize_clamped, rrc_box
from test_torch_jpeg_codec import photo
from torch_io_fixtures import exif_app1

STD = (0.229, 0.224, 0.225)
LEVEL = 1.0 / (255.0 * min(STD)) + 1e-5

# (H, W): three canvases at bucket_blocks=2, 4:2:0
SIZES = [(75, 100), (100, 75), (66, 100), (75, 100), (100, 75), (64, 90),
         (70, 96), (99, 80), (75, 100), (60, 100), (100, 60), (80, 100)]


def jpeg(h, w, seed, **kw):
    buf = io.BytesIO()
    kw.setdefault("quality", 85)
    PIL.Image.fromarray(photo(h, w, seed=seed)).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def samples():
    """Twelve streams, every third progressive, labels their index."""
    return [(jpeg(h, w, i, progressive=i % 3 == 0), i) for i, (h, w) in enumerate(SIZES)]


def kw(**extra):
    return dict(dict(batch_size=3, crop_size=32, val_resize_size=36, bucket_blocks=2),
                **extra)


def recorded_buckets(monkeypatch):
    """The JAX loader's bucket of each batch it emits."""
    seen = []
    emit = TpuJpegLoader._emit

    def record(self, bk, items, key):
        seen.append(bk)
        return emit(self, bk, items, key)

    monkeypatch.setattr(TpuJpegLoader, "_emit", record)
    return seen


@pytest.mark.parametrize("coef_limit", [0, 5])
def test_eval_batches_equal_jax(samples, coef_limit, monkeypatch):
    seen = recorded_buckets(monkeypatch)
    want = list(TpuJpegLoader(samples, train=False, coef_limit=coef_limit, **kw()))
    loader = DeviceJpegLoader(samples, train=False, coef_limit=coef_limit,
                              device="cpu", **kw())
    got = list(loader)
    assert loader.buckets == seen and len(got) == len(want)
    for g, w in zip(got, want):
        assert g["image"].shape == (w["image"].shape[0], 3, 32, 32)
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))
        err = np.abs(g["image"].numpy() - np.asarray(w["image"]).transpose(0, 3, 1, 2))
        assert err.max() <= LEVEL
    assert loader.stats == {"offload": 12, "reencode_fallback": 0,
                            "exif_reorient": 0, "dropped": 0}


def jax_boxes(key, dims, scale, ratio):
    """The boxes and flips that ``tpu_loader._device_batch`` draws from
    ``key`` for images of true sizes ``dims``."""
    boxes, flips = [], []
    for k, (th, tw) in zip(jax.random.split(key, len(dims)), dims):
        kc, kf = jax.random.split(k)
        top, left, h, w = tpu_loader._traced_rrc_params(
            jnp.float32(th), jnp.float32(tw), kc, scale, ratio)
        boxes.append([float(top), float(left), float(h), float(w)])
        flips.append(bool(jax.random.uniform(kf) < 0.5))
    return boxes, flips


@pytest.mark.parametrize("coef_limit", [0, 3])
def test_train_batches_equal_jax_given_its_boxes_and_flips(samples, coef_limit):
    loader = DeviceJpegLoader(samples, train=True, coef_limit=coef_limit,
                              device="cpu", **kw())
    items = []
    for i in range(len(samples)):
        lane, r, label = loader._coefficients(i)
        items.append((loader._bucket_key([c.shape for c in r[0]], r[2]),
                      (r[0], r[1], r[3], label)))
    bk = items[0][0]
    chosen = [it for k, it in items if k == bk][:3]
    coefs, qtabs, dims, labels = loader.stage(bk, chosen)
    key = jax.random.PRNGKey(7)
    boxes, flips = jax_boxes(key, dims, loader.scale, loader.ratio)
    assert any(flips) and not all(flips)
    want = tpu_loader._device_batch(
        tuple(jnp.asarray(c.numpy()) for c in coefs),
        tuple(jnp.asarray(q.numpy()) for q in qtabs),
        jnp.asarray(np.array(dims, np.float32)), jnp.asarray(labels.numpy()), key,
        canvas_h=bk[0] * 8, canvas_w=bk[1] * 8, samp=bk[2], train=True,
        crop_size=32, val_resize_size=36, mean=loader.mean, std=loader.std,
        scale=loader.scale, ratio=loader.ratio)
    got = loader.device_batch(coefs, qtabs, dims, labels, boxes, flips, bk)
    err = np.abs(got["image"].numpy() - np.asarray(want["image"]).transpose(0, 3, 1, 2))
    assert err.max() <= LEVEL


def test_the_port_draws_boxes_as_jax_does_from_the_same_numbers():
    """``rrc_box`` is ``_traced_rrc_params`` on the same uniform draws:
    the first candidate that fits, else the centre fallback."""
    rng = np.random.RandomState(0)
    for th, tw in ((75, 100), (300, 40), (40, 300), (8, 8)):
        for _ in range(20):
            u = rng.rand(22)
            got = rrc_box(th, tw, u.tolist(), (0.08, 1.0), (3 / 4, 4 / 3))
            area = th * tw * (0.08 + 0.92 * u[:10])
            aspect = np.exp(np.log(3 / 4) + (np.log(4 / 3) - np.log(3 / 4)) * u[10:20])
            ws, hs = np.round(np.sqrt(area * aspect)), np.round(np.sqrt(area / aspect))
            ok = (ws > 0) & (ws <= tw) & (hs > 0) & (hs <= th)
            if ok.any():
                i = int(np.argmax(ok))
                assert got == (np.floor(u[20] * (th - hs[i] + 1)),
                               np.floor(u[21] * (tw - ws[i] + 1)), hs[i], ws[i])
            else:
                assert got[2] <= th and got[3] <= tw


def test_crop_reads_no_padding():
    """Sample coordinates are clamped to the true size: whatever fills the
    canvas past it does not change the crop."""
    img = torch.rand(2, 3, 40, 48)
    other = img.clone()
    other[:, :, 30:] = 1e6
    other[:, :, :, 37:] = -1e6
    boxes = torch.tensor([[0.0, 0.0, 30.0, 37.0], [10.0, 5.0, 25.0, 40.0]])
    dims = torch.tensor([[30.0, 37.0], [30.0, 37.0]])
    a = crop_resize_clamped(img, boxes, dims, (16, 16))
    b = crop_resize_clamped(other, boxes, dims, (16, 16))
    assert torch.equal(a, b)


def test_each_stats_lane_equals_jax(samples, tmp_path):
    """Progressive streams ride the offload lane; CMYK and PNG the
    re-encode lane; an EXIF-turned stream (with ``apply_exif_orientation``)
    its own; bytes that no decoder reads are dropped, and say why."""
    buf = io.BytesIO()
    cmyk = np.clip(photo(75, 100, seed=3).astype(int)[..., [0, 1, 2, 0]], 0, 255)
    PIL.Image.frombytes("CMYK", (100, 75), cmyk.astype(np.uint8).tobytes()).save(
        buf, "JPEG", quality=90)
    base = jpeg(100, 75, 4)
    exif = base[:2] + exif_app1(6) + base[2:]
    png = encode_png(torch.from_numpy(photo(75, 100, seed=5)).permute(2, 0, 1))
    mixed = samples[:6] + [(buf.getvalue(), 20), (exif, 21), (png, 22), (b"junk" * 9, 23)]
    want = TpuJpegLoader(mixed, train=False, apply_exif_orientation=True, **kw())
    wb = list(want)
    got = DeviceJpegLoader(mixed, train=False, apply_exif_orientation=True,
                           device="cpu", **kw())
    gb = list(got)
    assert got.stats == want.stats == {"offload": 6, "reencode_fallback": 2,
                                       "exif_reorient": 1, "dropped": 1}
    assert [i for i, _ in got.drop_reasons] == [9]
    assert got.offload_hit_rate == want.offload_hit_rate == 0.6
    assert sorted(int(v) for b in gb for v in b["label"]) == \
        sorted(int(v) for b in wb for v in np.asarray(b["label"]))
    list(got)
    assert got.stats_total == {"offload": 6, "reencode_fallback": 2,
                               "exif_reorient": 1, "dropped": 1}


def test_file_paths_read_as_bytes(samples, tmp_path):
    paths = []
    for data, label in samples[:4]:
        p = tmp_path / f"{label}.jpg"
        p.write_bytes(data)
        paths.append((str(p), label))
    a = list(DeviceJpegLoader(paths, train=False, device="cpu", **kw()))
    b = list(DeviceJpegLoader(samples[:4], train=False, device="cpu", **kw()))
    for x, y in zip(a, b):
        assert torch.equal(x["image"], y["image"])


@pytest.mark.parametrize("count", [2, 3, 5])
def test_shards_are_disjoint_complete_and_in_lockstep(samples, count):
    """Every process sees a strided slice of one padded permutation: the
    shards cover every sample, overlap only in the wrap-around padding,
    and every process emits exactly ``len(loader)`` full batches, as the
    JAX loader's processes do, with the same labels."""
    seen = []
    for rank in range(count):
        port = DeviceJpegLoader(samples, train=True, process_index=rank,
                                process_count=count, device="cpu", seed=3, **kw())
        jax_ = TpuJpegLoader(samples, train=True, process_index=rank,
                             process_count=count, seed=3, **kw())
        pb, jb = list(port), list(jax_)
        assert len(pb) == len(jb) == len(port) == len(jax_)
        assert all(b["image"].shape[0] == 3 for b in pb)
        labels = [int(v) for b in pb for v in b["label"]]
        assert labels == [int(v) for b in jb for v in np.asarray(b["label"])]
        seen.append(set(labels))
    shard = -(-len(samples) // count)
    assert set().union(*seen) <= set(range(len(samples)))
    overlap = sum(len(a & b) for i, a in enumerate(seen) for b in seen[i + 1:])
    assert overlap <= shard * count - len(samples) + 3 * count


def test_drop_remainder_set_epoch_and_the_default_world(samples, monkeypatch):
    loader = DeviceJpegLoader(samples, train=True, drop_remainder=True, device="cpu",
                              **kw())
    assert (loader.process_index, loader.process_count) == (0, 1)
    first = [b["label"].tolist() for b in loader]
    assert all(len(b) == 3 for b in first)
    again = [b["label"].tolist() for b in loader]
    assert again == first
    loader.set_epoch(1)
    assert [b["label"].tolist() for b in loader] != first
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceJpegLoader(samples, 3)
