"""The port's folder datasets, ImageNet, sampler, collation, loader and
dataset helpers (``vision_tpu_torch.datasets``) against
``vision_tpu.datasets`` on the same temporary trees, on the CPU; and the
ImageNet-layout tree of ``tools/imagenet_folder.py``.

The trees hold PNGs, so that the two packages' default loaders must give
the same pixels element for element (libpng against the port's decoder);
the port's samples are CHW tensors where the JAX package's are HWC
arrays.
"""

import gzip
import os
import pickle
import tarfile
import zipfile

import numpy as np
import PIL.Image
import pytest
import scipy.io
import torch

import vision_tpu.datasets as jd
from vision_tpu.datasets import utils as jutils
from vision_tpu_torch import datasets as pd
from vision_tpu_torch.datasets import utils as putils
from vision_tpu_torch.io import DeviceJpegLoader
from vision_tpu_torch.tools import imagenet_folder

CLASSES = ("n01440764", "n01443537", "n02102040")


def write_png(path, seed, mode="RGB", size=(13, 17)):
    rng = np.random.RandomState(seed)
    c = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    arr = rng.randint(0, 256, size + (c,), np.uint8)
    PIL.Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/{train,val}/<wnid>/ of PNGs of three modes, a file of another
    extension, a nested folder; an empty class folder in val/."""
    root = tmp_path_factory.mktemp("imagenet")
    for split, n in (("train", 4), ("val", 2)):
        for ci, wnid in enumerate(CLASSES):
            d = root / split / wnid
            d.mkdir(parents=True)
            if split == "val" and ci == 2:
                continue
            for j in range(n):
                write_png(d / f"{wnid}_{j}.png", 10 * ci + j, ("RGB", "L", "RGBA")[j % 3])
            (d / "notes.txt").write_text("not an image")
        (root / split / CLASSES[0] / "sub").mkdir()
        write_png(root / split / CLASSES[0] / "sub" / "deep.PNG", 99)
    return root


def test_find_classes_and_make_dataset_equal_jax(tree):
    train = str(tree / "train")
    assert pd.find_classes(train) == jd.folder.find_classes(train)
    for ext in (pd.IMG_EXTENSIONS, (".png",), ".txt"):
        assert pd.make_dataset(train, extensions=ext) == jd.folder.make_dataset(
            train, extensions=ext)
    valid = lambda p: p.endswith("_1.png")  # noqa: E731
    assert pd.make_dataset(train, is_valid_file=valid) == jd.folder.make_dataset(
        train, is_valid_file=valid)
    with pytest.raises(ValueError):
        pd.make_dataset(train)
    with pytest.raises(FileNotFoundError, match=CLASSES[2]):
        pd.make_dataset(str(tree / "val"), extensions=(".png",))
    assert pd.make_dataset(str(tree / "val"), extensions=(".png",), allow_empty=True) == \
        jd.folder.make_dataset(str(tree / "val"), extensions=(".png",), allow_empty=True)
    with pytest.raises(FileNotFoundError):
        pd.find_classes(str(tree / "train" / CLASSES[0] / "sub"))


def test_image_folder_equals_jax(tree):
    port = pd.ImageFolder(str(tree / "train"))
    jax = jd.ImageFolder(str(tree / "train"))
    assert port.classes == jax.classes and port.class_to_idx == jax.class_to_idx
    assert port.samples == jax.samples == port.imgs and port.targets == jax.targets
    assert len(port) == len(jax) == 13
    for i in range(len(port)):
        (x, y), (xj, yj) = port[i], jax[i]
        assert x.dtype == torch.uint8 and x.shape[0] == 3 and y == yj
        np.testing.assert_array_equal(x.permute(1, 2, 0).numpy(), xj)
    flipped = pd.ImageFolder(str(tree / "train"), transform=lambda t: t.flip(-1),
                             target_transform=lambda y: y + 10)
    x, y = flipped[0]
    assert torch.equal(x, port[0][0].flip(-1)) and y == port[0][1] + 10
    assert "Number of datapoints: 13" in repr(port)


def test_dataset_folder_with_a_loader_of_bytes(tree):
    port = pd.DatasetFolder(str(tree / "train"), loader=lambda p: open(p, "rb").read(),
                            extensions=(".png",))
    jax = jd.DatasetFolder(str(tree / "train"), loader=lambda p: open(p, "rb").read(),
                           extensions=(".png",))
    assert port.samples == jax.samples
    assert [port[i] for i in range(len(port))] == [jax[i] for i in range(len(jax))]
    with pytest.raises(RuntimeError, match="PIL"):
        pd.pil_loader(port.samples[0][0])
    with pytest.raises(ValueError, match="transforms"):
        pd.VisionDataset("x", transforms=lambda a, b: (a, b), transform=lambda a: a)
    st = pd.StandardTransform(lambda a: a + 1, lambda b: b * 2)
    assert st(1, 2) == (2, 4)


def test_imagenet_with_its_meta_file_equals_jax(tree):
    wnid_to_classes = {CLASSES[0]: ("tench", "Tinca tinca"),
                       CLASSES[1]: ("goldfish",), CLASSES[2]: ("cocker spaniel",)}
    with open(tree / "meta.bin", "wb") as f:
        pickle.dump((wnid_to_classes, [CLASSES[0]] * 4), f)
    try:
        for split in ("train", "val"):
            kw = {"allow_empty": True} if split == "val" else {}
            port = pd.ImageNet(str(tree), split, **kw)
            jax = jd.ImageNet(str(tree), split, **kw)
            assert port.wnids == jax.wnids and port.classes == jax.classes
            assert port.class_to_idx == jax.class_to_idx
            assert port.wnid_to_idx == jax.wnid_to_idx
            assert port.samples == jax.samples and port.root == jax.root
        assert port.class_to_idx["Tinca tinca"] == 0
    finally:
        os.remove(tree / "meta.bin")
    with pytest.raises(ValueError, match="split"):
        pd.ImageNet(str(tree), "test")
    assert pd.ImageNet(str(tree), "train").classes == list(CLASSES)


def test_parse_devkit_meta_equals_jax(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    rec = np.dtype([("ILSVRC2012_ID", "O"), ("WNID", "O"), ("words", "O"),
                    ("gloss", "O"), ("num_children", "O")])
    synsets = np.array([(1, "n1", "tench, Tinca tinca", "a fish", 0),
                        (2, "n2", "goldfish", "a fish", 0),
                        (3, "n0", "fish", "a class", 2)], dtype=rec)
    scipy.io.savemat(data / "meta.mat", {"synsets": synsets})
    (data / "ILSVRC2012_validation_ground_truth.txt").write_text("2\n1\n2\n")
    got = pd.parse_devkit_meta(str(tmp_path))
    assert got == jd.imagenet.parse_devkit_meta(str(tmp_path))
    assert got == ({"n1": ("tench", "Tinca tinca"), "n2": ("goldfish",)},
                   ["n2", "n1", "n2"])


@pytest.mark.parametrize("n,replicas,drop_last", [(10, 3, False), (10, 3, True),
                                                  (2, 5, False), (12, 4, False)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_sampler_equals_jax(n, replicas, drop_last, shuffle):
    data = list(range(n))
    for epoch in (0, 3):
        got, want = [], []
        for rank in range(replicas):
            p = pd.DistributedSampler(data, replicas, rank, shuffle, seed=5,
                                      drop_last=drop_last)
            j = jd.samplers.DistributedSampler(data, replicas, rank, shuffle, seed=5,
                                               drop_last=drop_last)
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(p) == list(j) and len(p) == len(j)
            got += list(p)
        if not drop_last:
            assert set(got) == set(data)
    assert isinstance(p, torch.utils.data.Sampler)
    with pytest.raises(ValueError):
        pd.DistributedSampler(data, 2, 2)


class Numbers:
    """Samples of every kind ``default_collate`` takes."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return (np.full((2, 3), i, np.float32), i, float(i) / 2,
                {"name": f"s{i}", "v": np.arange(3) + i})


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_data_loader_and_collate_equal_jax(workers, shuffle, drop_last):
    port = pd.DataLoader(Numbers(), batch_size=4, shuffle=shuffle, num_workers=workers,
                         drop_last=drop_last, seed=2)
    jax = jd.samplers.DataLoader(Numbers(), batch_size=4, shuffle=shuffle,
                                 num_workers=workers, drop_last=drop_last, seed=2)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        got, want = list(port), list(jax)
        assert len(got) == len(want) == len(port) == len(jax)
        for g, w in zip(got, want):
            assert isinstance(g, tuple) and g[0].dtype == torch.float32
            np.testing.assert_array_equal(g[0].numpy(), w[0])
            assert g[1].dtype == torch.int64 and g[1].tolist() == w[1].tolist()
            assert g[2].dtype == torch.float64 and g[2].tolist() == w[2].tolist()
            assert g[3]["name"] == w[3]["name"]
            np.testing.assert_array_equal(g[3]["v"].numpy(), w[3]["v"])
    sampler = pd.DistributedSampler(Numbers(), 2, 1, seed=1)
    port = pd.DataLoader(Numbers(), batch_size=3, sampler=sampler)
    jax = jd.samplers.DataLoader(
        Numbers(), batch_size=3, sampler=jd.samplers.DistributedSampler(Numbers(), 2, 1,
                                                                        seed=1))
    assert [b[1].tolist() for b in port] == [b[1].tolist() for b in jax]


def test_dataset_helpers_equal_jax(tmp_path):
    blob = tmp_path / "blob.bin"
    blob.write_bytes(bytes(range(256)) * 100)
    md5 = putils.calculate_md5(str(blob))
    assert md5 == jutils.calculate_md5(str(blob))
    assert putils.check_integrity(str(blob), md5) and putils.check_integrity(str(blob))
    assert not putils.check_integrity(str(blob), "0" * 32)
    assert not putils.check_integrity(str(tmp_path / "missing"))
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("alpha")
    with tarfile.open(tmp_path / "x.tar.gz", "w:gz") as t:
        t.add(src / "a.txt", arcname="a.txt")
    with zipfile.ZipFile(tmp_path / "x.zip", "w") as z:
        z.write(src / "a.txt", "b.txt")
    with gzip.open(tmp_path / "c.txt.gz", "wb") as g:
        g.write(b"gamma")
    out_p, out_j = tmp_path / "p", tmp_path / "j"
    out_p.mkdir()
    out_j.mkdir()
    for name in ("x.tar.gz", "x.zip", "c.txt.gz"):
        assert putils.extract_archive(str(tmp_path / name), str(out_p)) == str(out_p)
        jutils.extract_archive(str(tmp_path / name), str(out_j))
    assert sorted(os.listdir(out_p)) == sorted(os.listdir(out_j)) == ["a.txt", "b.txt", "c.txt"]
    assert (out_p / "c.txt").read_bytes() == b"gamma"
    with pytest.raises(ValueError, match="unsupported"):
        putils.extract_archive(str(blob))
    assert sorted(putils.list_dir(str(tmp_path))) == sorted(jutils.list_dir(str(tmp_path)))
    assert putils.list_files(str(tmp_path), ".zip", prefix=True) == \
        jutils.list_files(str(tmp_path), ".zip", prefix=True)
    assert putils.verify_str_arg("val", "split", ("train", "val")) == "val"
    for bad in (3, "test"):
        with pytest.raises(ValueError) as got:
            putils.verify_str_arg(bad, "split", ("train", "val"))
        with pytest.raises(ValueError) as want:
            jutils.verify_str_arg(bad, "split", ("train", "val"))
        assert str(got.value) == str(want.value)
    assert putils.iterable_to_str(["a", 1]) == jutils.iterable_to_str(["a", 1])
    assert putils.path_or_str(tmp_path) == str(tmp_path)


def test_imagenet_folder_tree_through_both_lanes(tmp_path):
    """A small tree of the tool: ``ImageFolder`` finds every file, the
    loader reads the JPEGs of train/ (progressive, EXIF and CMYK copies
    among them) with nothing dropped, and val/'s PNGs ride the re-encode
    lane."""
    kinds = imagenet_folder.write_tree(tmp_path, classes=2, train_per_class=8,
                                       val_per_class=5, sizes=[(75, 100), (100, 75)])
    assert kinds["train"] == {"baseline": 4, "progressive": 8, "exif": 2, "cmyk": 2,
                              "png": 0, "files": 16}
    assert kinds["val"]["png"] == 4 and kinds["val"]["files"] == 10
    train = pd.ImageFolder(str(tmp_path / "train"))
    assert len(train) == 16 and train.classes == ["n01440764", "n01441764"]
    loader = DeviceJpegLoader(train.samples, 4, 32, train=True,
                              apply_exif_orientation=True, device="cpu")
    n = sum(b["label"].shape[0] for b in loader)
    assert n == 16 and loader.stats == {"offload": 12, "reencode_fallback": 2,
                                        "exif_reorient": 2, "dropped": 0}
    val = pd.ImageFolder(str(tmp_path / "val"))
    loader = DeviceJpegLoader(val.samples, 4, 32, train=False, device="cpu")
    assert sum(b["label"].shape[0] for b in loader) == 10
    assert loader.stats["reencode_fallback"] == 6 and loader.stats["dropped"] == 0
    host = pd.DataLoader(pd.ImageFolder(str(tmp_path / "val"),
                                        transform=lambda x: x[:, :8, :8]),
                         batch_size=4, num_workers=2)
    assert sum(y.shape[0] for _, y in host) == 10
