"""The port's detection and segmentation recipes
(``vision_tpu_torch/references``, ``parallel.SegmentationPresetTrain`` /
``Eval``) against the repo's ``references/`` on the CPU: the segmentation
preset within one uint8 level of JAX's with JAX's ``RandomState`` draws
handed across (masks exactly); ``ConfusionMatrix`` exactly; the poly and
warmup schedules; the training utilities; ``evaluate_detection`` on the
same detections; the trainers' flags and defaults. Then both trainers run
on the CPU: two steps on fake data, and one step from a tiny COCO or VOC
tree of ``tools/coco_folder.py`` with a checkpoint, evaluated by
``--test-only --resume``. The detection trainer runs the MobileNetV3
320 Faster R-CNN there (a CPU step of Mask R-CNN R50 takes ~20 s); its
mask path's batches are checked through ``coco_batches``."""

import math

import numpy as np
import pytest
import torch

from vision_tpu_torch.models.detection.roi_heads import Detections
from vision_tpu_torch.parallel import SegmentationPresetEval, SegmentationPresetTrain
from vision_tpu_torch.references.classification import utils as putils
from vision_tpu_torch.references.detection import engine as pengine
from vision_tpu_torch.references.detection import train as pdet
from vision_tpu_torch.references.segmentation import train as pseg
from vision_tpu_torch.tools import coco_folder
from vision_tpu_torch.transforms.v2 import Replay
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_refs_cases import load_reference

pytestmark = pytest.mark.usefixtures("few_torch_threads")

jseg = load_reference("segmentation", "train")
jpresets = load_reference("segmentation", "presets")
jdet = load_reference("detection", "train")
jengine = load_reference("detection", "engine")
jutils = load_reference("classification", "utils")

STD = (0.229, 0.224, 0.225)
LEVEL = 1.0 / 255.0 / min(STD) + 1e-6  # one uint8 level, normalised


class SpyState(np.random.RandomState):
    """A ``RandomState`` that keeps what ``randint`` and ``rand`` gave."""

    def __init__(self, seed):
        super().__init__(seed)
        self.drawn = []

    def randint(self, *a, **k):
        v = super().randint(*a, **k)
        self.drawn.append(int(v))
        return v

    def rand(self, *a):
        v = super().rand(*a)
        self.drawn.append(float(v))
        return v


@pytest.mark.parametrize("hw,base,crop", [((30, 40), 32, 48), ((75, 100), 64, 64),
                                          ((120, 90), 48, 40), ((61, 61), 20, 30)])
@pytest.mark.parametrize("seed", range(3))
def test_segmentation_preset_train_equals_jax(hw, base, crop, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    mask = rng.randint(0, 21, hw).astype(np.uint8)
    mask[rng.rand(*hw) < 0.1] = 255
    spy = SpyState(seed + 10)
    ji, jm = jpresets.SegmentationPresetTrain(base_size=base, crop_size=crop)(img, mask, spy)
    size, u, top, left = spy.drawn
    preset = SegmentationPresetTrain(base_size=base, crop_size=crop, device="cpu")
    pi, pm = preset((torch.from_numpy(img).permute(2, 0, 1), torch.from_numpy(mask)),
                    Replay([dict(size=size, flip=u < 0.5, top=top, left=left)]))
    assert pi.dtype == torch.float32 and pi.shape == (3, crop, crop)
    assert pm.dtype == torch.int64
    np.testing.assert_array_equal(pm.numpy(), jm)
    assert np.abs(pi.permute(1, 2, 0).numpy() - ji).max() <= LEVEL


def test_segmentation_preset_draws_and_eval_equal_jax():
    """The port's own draws (a CPU generator) land in JAX's ranges; the
    eval preset equals JAX's."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    mask = rng.randint(0, 21, (50, 70)).astype(np.uint8)
    preset = SegmentationPresetTrain(base_size=40, crop_size=32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    sizes = set()
    for _ in range(40):
        from vision_tpu_torch.transforms.v2 import Record
        rec = Record(gen)
        x, t = preset((torch.from_numpy(img).permute(2, 0, 1), torch.from_numpy(mask)), rec)
        (p,) = rec.params
        sizes.add(p["size"])
        assert 20 <= p["size"] <= 80 and x.shape == (3, 32, 32) and t.shape == (32, 32)
    assert len(sizes) > 10
    ji, jm = jpresets.SegmentationPresetEval(base_size=36)(img, mask)
    pi, pm = SegmentationPresetEval(base_size=36, device="cpu")(
        (torch.from_numpy(img).permute(2, 0, 1), torch.from_numpy(mask)))
    np.testing.assert_array_equal(pm.numpy(), jm)
    assert np.abs(pi.permute(1, 2, 0).numpy() - ji).max() <= LEVEL


def test_confusion_matrix_equals_jax():
    rng = np.random.RandomState(0)
    j, p = jseg.ConfusionMatrix(21), pseg.ConfusionMatrix(21)
    for _ in range(3):
        t = rng.randint(0, 21, (2, 17, 23))
        t[rng.rand(*t.shape) < 0.1] = 255
        pred = np.where(rng.rand(*t.shape) < 0.6, np.where(t == 255, 0, t),
                        rng.randint(0, 21, t.shape))
        j.update(t, pred)
        p.update(torch.from_numpy(t), torch.from_numpy(pred))
    np.testing.assert_array_equal(p.mat, j.mat)
    for a, b in zip(p.compute(), j.compute()):
        np.testing.assert_array_equal(a, b)
    assert str(p) == str(j)
    gt = pseg.ConfusionMatrix(21)
    full = torch.from_numpy(np.tile(np.arange(21), 4).reshape(4, 21))
    gt.update(full, full)
    acc, _, iou = gt.compute()
    assert acc == 1.0 and iou.mean() == 1.0


@pytest.mark.parametrize("warmup,method", [(0, "linear"), (5, "linear"), (5, "constant")])
def test_poly_lr_schedule_equals_jax(warmup, method):
    j = jseg.poly_lr_schedule(0.01, 40, warmup_iters=warmup, warmup_method=method)
    p = pseg.poly_lr_schedule(0.01, 40, warmup_iters=warmup, warmup_method=method)
    for s in range(45):  # JAX's schedule is f32
        assert math.isclose(p(s), float(j(s)), rel_tol=1e-6, abs_tol=1e-12)


def test_detection_schedules_equal_jax():
    args = pdet.get_args_parser().parse_args(["--epochs", "26"])
    for sched in ("multisteplr", "cosineannealinglr"):
        args.lr_scheduler = sched
        for epoch in (0, 15, 16, 21, 22, 25):
            assert math.isclose(pdet.epoch_lr(args, epoch), jdet.epoch_lr(args, epoch),
                                rel_tol=1e-12)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.02)
    warm = pdet.WarmupLR(opt, 1000, 0.02)
    want = jdet.warmup_schedule(0.02, 1000)
    for s in range(1200):  # JAX's schedule is f32
        if s % 37 == 0 or s in (999, 1000, 1001):
            assert math.isclose(opt.param_groups[0]["lr"], float(want(s)), rel_tol=1e-6)
        warm.step()


def test_trainers_keep_jax_flags_and_defaults():
    for port, jax_mod in ((pdet, jdet), (pseg, jseg)):
        got = vars(port.get_args_parser().parse_args([]))
        want = vars(jax_mod.get_args_parser().parse_args([]))
        assert got.pop("device") is None
        assert got == want
        opts = lambda p: {o for a in p._actions for o in a.option_strings}
        assert opts(port.get_args_parser()) - {"--device"} == opts(jax_mod.get_args_parser())


def test_metric_logger_and_checkpoints_equal_jax(tmp_path):
    p, j = putils.SmoothedValue(window_size=4), jutils.SmoothedValue(window_size=4)
    for v in (3.0, 1.0, 4.0, 1.0, 5.0, 9.0):
        p.update(v, n=2)
        j.update(v, n=2)
    assert str(p) == str(j)
    for k in ("median", "avg", "global_avg", "max", "value"):
        assert getattr(p, k) == getattr(j, k)
    logs = []
    for mod in (putils, jutils):
        m = mod.MetricLogger()
        out = list(m.log_every(range(5), 2, "h"))
        m.update(loss=2.5, acc=torch.tensor(0.5) if mod is putils else 0.5)
        logs.append((out, str(m)))
    assert logs[0] == logs[1]
    state = {"model": {"w": torch.arange(3.0)}, "epoch": 4}
    putils.save_checkpoint(str(tmp_path / "c" / "ck.pth"), state)
    back = putils.load_checkpoint(str(tmp_path / "c" / "ck.pth"))
    assert back["epoch"] == 4 and torch.equal(back["model"]["w"], state["model"]["w"])


def test_evaluate_detection_equals_jax():
    """The same detections (valid rows, padding) through both engines'
    ``evaluate_detection`` with a box map back to each image."""
    rng = np.random.RandomState(0)
    n, d = 2, 6
    gts, batches = {}, []
    for b in range(3):
        boxes = np.sort(rng.uniform(0, 60, (n, d, 4)).reshape(n, d, 2, 2), 2
                        ).reshape(n, d, 4).astype(np.float32)
        scores = rng.rand(n, d).astype(np.float32)
        labels = rng.randint(1, 4, (n, d))
        valid = rng.rand(n, d) < 0.7
        ids = [2 * b, 2 * b + 1]
        for i, k in enumerate(ids):
            gts[k] = {"boxes": boxes[i][:3] * 2 + rng.normal(0, 1, (3, 4)),
                      "labels": labels[i][:3], "iscrowd": np.zeros(3, np.int64)}
        batches.append((ids, (boxes, scores, labels, valid), [(60, 60)] * n, [(120, 120)] * n))

    class JDets:
        def __init__(self, t):
            self.boxes, self.scores, self.labels, self.valid = t

    def jpost(bx, size, orig):
        return bx * (orig[0] / size[0])

    want = jengine.evaluate_detection(JDets, iter(batches), gts, jpost)
    port_batches = [(ids, Detections(*(torch.from_numpy(np.asarray(t)) for t in dets)),
                     sizes, orig) for ids, dets, sizes, orig in batches]
    got = pengine.evaluate_detection(lambda x: x, iter(port_batches), gts,
                                     lambda bx, size, orig: bx * (orig[0] / size[0]))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_tree")
    coco = coco_folder.write_coco_tree(root, train=5, val=2, empty=(1,),
                                       sizes=((120, 160), (160, 120)))
    voc = coco_folder.write_voc_tree(root, train=4, val=5, sizes=((60, 80), (80, 60)))
    return root, coco, voc


def det_args(*extra):
    return pdet.get_args_parser().parse_args(
        ["--device", "cpu", "--model", "fasterrcnn_mobilenet_v3_large_320_fpn",
         "--epochs", "1", "--print-freq", "1", "--max-boxes", "4", *extra])


def test_detection_trainer_runs_on_fake_data_and_a_coco_tree(tiny, tmp_path):
    root, coco, _ = tiny
    out = pdet.main(det_args("--fake-data", "--steps-per-epoch", "2", "--size", "64"))
    assert len(out["steps"]) == 2
    assert all(math.isfinite(s["losses"]["loss"]) for s in out["steps"])
    seen = []
    out = pdet.main(det_args("--data-path", str(root), "--steps-per-epoch", "1",
                             "--output-dir", str(tmp_path)),
                    hooks={"before_first": lambda m, b, g: seen.append(b["image"].shape),
                           "after_first": lambda m: seen.append(m.training)})
    assert out["images_kept"] == coco["train"]["images"] - coco["train"]["empty"]
    assert len(out["steps"]) == 1 and math.isfinite(out["steps"][0]["losses"]["loss"])
    assert seen == [(2, 3, 640, 640), True]  # its 320 / 640 transform
    assert out["host"]["samples"] == 2 and len(out["epoch_s"]) == 1
    ev = pdet.main(det_args("--data-path", str(root), "--test-only", "--resume",
                            str(tmp_path / "checkpoint_0.pth")))["metrics"]
    assert ev["images"] == 2 and {"map", "map_50", "map_75"} <= ev.keys()
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        pdet.main(det_args("--weights", str(tmp_path / "none.pth"), "--fake-data"))
    # --weights and --weights-backbone read state-dict files on disk
    state = torch.load(tmp_path / "checkpoint_0.pth", weights_only=True)["model"]
    body = {k[len("backbone.body."):]: v for k, v in state.items()
            if k.startswith("backbone.body.")}
    torch.save(body, tmp_path / "body.pth")
    for flag, path in (("--weights", "checkpoint_0.pth"), ("--weights-backbone", "body.pth")):
        again = pdet.main(det_args("--data-path", str(root), "--test-only", flag,
                                   str(tmp_path / path)))["metrics"]
        if flag == "--weights":
            assert again == dict(ev, seconds=again["seconds"])


def test_detection_optimizer_groups_norms():
    """``--norm-weight-decay``: the normalisation layers' parameters (the
    port's and torch's) in a group of their own; ``--opt adamw``."""
    from vision_tpu_torch.ops.misc import BatchNorm2d, GroupNorm

    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), BatchNorm2d(8),
                                GroupNorm(2, 8), torch.nn.LayerNorm(8))
    args = pdet.get_args_parser().parse_args(["--norm-weight-decay", "0"])
    groups = pdet.make_optimizer(args, model).param_groups
    assert [g["weight_decay"] for g in groups] == [1e-4, 0.0]
    assert [len(g["params"]) for g in groups] == [2, 6]
    args = pdet.get_args_parser().parse_args(["--opt", "adamw"])
    opt = pdet.make_optimizer(args, model)
    assert isinstance(opt, torch.optim.AdamW) and len(opt.param_groups) == 1


def test_detection_batches_carry_masks(tiny):
    """``coco_batches`` with ``--with-masks``: the Mask R-CNN batch, masks
    on the transform's canvas, as many rows as boxes."""
    root, _, _ = tiny
    args = det_args("--data-path", str(root), "--with-masks", "--model",
                    "maskrcnn_resnet50_fpn", "--size", "96")
    from vision_tpu_torch.references.detection.coco_utils import get_coco

    ds = get_coco(str(root), "train", with_masks=True)
    host = dict.fromkeys(("decode", "rasterise", "preset", "collate", "samples"), 0)
    batches = list(pdet.coco_batches(args, ds, pdet.model_transform(args, "cpu"),
                                     torch.device("cpu"), 0, host))
    assert len(batches) == 2 and host["samples"] == 4
    for b in batches:
        n, g = b["valid"].shape
        assert (n, g) == (2, 4) and b["masks"].shape == (2, 4, *b["image"].shape[-2:])
        assert b["image"].shape[-1] == 160  # round(96 * 1333 / 800) up to 32
        for i in range(n):
            rows = b["masks"][i][b["valid"][i]]
            assert rows.sum((1, 2)).min() > 0 and b["masks"][i][~b["valid"][i]].sum() == 0


def seg_args(*extra):
    return pseg.get_args_parser().parse_args(
        ["--device", "cpu", "--model", "deeplabv3_resnet50", "--epochs", "1",
         "--batch-size", "2", "--size", "32", "--print-freq", "1", *extra])


def test_segmentation_trainer_runs_on_fake_data_and_a_voc_tree(tiny, tmp_path):
    root, _, voc = tiny
    out = pseg.main(seg_args("--fake-data", "--steps-per-epoch", "2"))
    assert len(out["steps"]) == 2 and out["eval"]["images"] == 4
    out = pseg.main(seg_args("--data-path", str(root), "--steps-per-epoch", "1",
                             "--output-dir", str(tmp_path)))
    assert len(out["steps"]) == 1 and math.isfinite(out["steps"][0]["loss"])
    assert out["steps"][0]["lr"] == 0.01 and out["eval"]["images"] == 4
    assert 0.0 <= out["eval"]["mean_iou"] <= 1.0
    ev = pseg.main(seg_args("--data-path", str(root), "--test-only", "--resume",
                            str(tmp_path / "checkpoint_0.pth")))["eval"]
    assert ev["images"] == 4 and ev["confmat"].mat.sum() > 0
    assert voc["val"]["classes"] == list(range(21))
