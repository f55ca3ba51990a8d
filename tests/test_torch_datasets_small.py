"""The port's small classification datasets (``vision_tpu_torch/datasets/
cifar.py``, ``mnist.py``, ``fakedata.py``, ``_small.py``) against their
``vision_tpu`` counterparts on the CPU, over trees written in each
dataset's own layout from seeded arrays
(``vision_tpu_torch/tools/small_datasets.py``).

Each of the 24 classes gives what ``vision_tpu``'s gives: length, targets,
``classes``, splits, and each sample's image as a ``[C, H, W]`` uint8
tensor where ``vision_tpu`` returns the HWC array: equal, or for JPEG files
within the port's bound of libjpeg's pixels (8 levels, ``ROADMAP.md``
section 3; PNG, IDX, pickled and ``.mat`` data exactly). FakeData draws
``vision_tpu``'s images at any offset. CIFAR's integrity check refuses a
tree whose digests are not its lists'. The collated batch on the card is
checked in ``test_torch_small_data_cuda.py``.
"""

import os

import numpy as np
import pytest
import torch

import vision_tpu.datasets as jdatasets
import vision_tpu_torch.datasets as datasets
from vision_tpu_torch.datasets import cifar as cifar_mod
from vision_tpu_torch.tools import small_datasets as sd

JPEG_BOUND = 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("small")
    specs = sd.write_all(root)
    specs["CIFAR10"] = {"train": True, "_lists": sd.write_cifar10(root, per_batch=6, test=5)}
    return root, specs


def image_files(ds):
    """The file behind each sample, where the dataset reads files."""
    if hasattr(ds, "samples"):
        return [p for p, _ in ds.samples]
    if hasattr(ds, "_samples"):
        return [p for p, _ in ds._samples]
    return None


NAMES = sorted(list(sd.READERS) + ["CIFAR10"])


@pytest.mark.parametrize("name", NAMES)
def test_each_dataset_reads_as_vision_tpus(name, tree):
    root, specs = tree
    port = sd.make_dataset(datasets, name, root, specs[name])
    ref = sd.make_dataset(jdatasets, name, root, specs[name])
    assert len(port) == len(ref) > 0
    for attr in ("classes", "class_to_idx", "categories"):
        assert getattr(port, attr, None) == getattr(ref, attr, None), attr
    files = image_files(port)
    for i in range(len(port)):
        (img, target), (want, want_target) = port[i], ref[i]
        if isinstance(target, tuple):  # OxfordIIITPet: category and trimap
            assert target[0] == want_target[0]
            np.testing.assert_array_equal(target[1].permute(1, 2, 0).numpy(),
                                          np.asarray(want_target[1]))
        else:
            assert target == want_target
        assert isinstance(img, torch.Tensor) and img.dtype == torch.uint8
        got = img.permute(1, 2, 0).numpy()
        want = np.asarray(want)
        assert got.shape == want.shape
        if files is not None and files[i].endswith(".jpg"):
            assert np.abs(got.astype(int) - want.astype(int)).max() <= JPEG_BOUND
        else:
            np.testing.assert_array_equal(got, want)
    for attr in ("targets", "labels"):
        if hasattr(ref, attr):
            np.testing.assert_array_equal(np.asarray(getattr(port, attr)),
                                          np.asarray(getattr(ref, attr)))


@pytest.mark.parametrize("offset", [0, 7])
def test_fakedata_draws_vision_tpus_images(offset):
    port = datasets.FakeData(5, (12, 10, 3), num_classes=4, random_offset=offset)
    ref = jdatasets.FakeData(5, (12, 10, 3), num_classes=4, random_offset=offset)
    for i in range(5):
        (img, target), (want, want_target) = port[i], ref[i]
        assert img.shape == (3, 12, 10) and target == want_target
        np.testing.assert_array_equal(img.permute(1, 2, 0).numpy(), want)
    with pytest.raises(IndexError):
        port[5]


def test_cifar_refuses_a_tree_whose_digests_differ(tree, monkeypatch):
    """The published digests do not match a written tree: the port's own
    check raises as ``vision_tpu``'s does; patched as ``vision_tpu``'s test
    patches it, or given the tree's lists, it reads."""
    root, specs = tree
    with pytest.raises(RuntimeError, match="not found or corrupted"):
        datasets.CIFAR10(str(root))
    with pytest.raises(RuntimeError, match="not found or corrupted"):
        jdatasets.CIFAR10(str(root))
    monkeypatch.setattr(cifar_mod, "check_integrity", lambda p, md5=None: os.path.isfile(p))
    ds = datasets.CIFAR10(str(root), train=False)
    assert len(ds) == 5 and ds.classes == sd.CIFAR10_CLASSES
    assert ds.data.shape == (5, 3, 32, 32) and ds.data.is_contiguous()


def test_gtsrb_refuses_ppm_as_vision_tpu_does(tmp_path):
    """The archive's ``.ppm`` files: neither decoder reads PPM."""
    folder = tmp_path / "gtsrb" / "GTSRB" / "Training" / "00003"
    folder.mkdir(parents=True)
    (folder / "00000_00000.ppm").write_bytes(b"P6\n2 2\n255\n" + bytes(12))
    port, ref = datasets.GTSRB(str(tmp_path)), jdatasets.GTSRB(str(tmp_path))
    assert len(port) == len(ref) == 1
    with pytest.raises(RuntimeError, match="Unsupported image format"):
        port[0]
    with pytest.raises(RuntimeError, match="Unsupported image format"):
        ref[0]


def test_read_idx_file_equals_vision_tpus(tree):
    root, _ = tree
    from vision_tpu.datasets.mnist import read_idx_file as jread

    for path in (root / "MNIST" / "raw" / "train-images-idx3-ubyte",
                 root / "QMNIST" / "raw" / "qmnist-test-labels-idx2-int"):
        got, want = datasets.read_idx_file(str(path)), jread(str(path))
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_a_dataloader_collates_each_dataset(tree):
    root, specs = tree
    for name in ("CIFAR10", "MNIST", "DTD", "STL10", "USPS"):
        ds = sd.make_dataset(datasets, name, root, specs[name])
        batch = next(iter(datasets.DataLoader(ds, batch_size=3, num_workers=2)))
        assert batch[0].shape == (3, *ds[0][0].shape) and batch[0].dtype == torch.uint8
        assert batch[1].tolist() == [int(ds[i][1]) for i in range(3)]

