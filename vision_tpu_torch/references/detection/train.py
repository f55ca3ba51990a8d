"""The detection trainer (the port's copy of the repo's
``references/detection/train.py``; reference
``references/detection/train.py``): COCO from files, or seeded fake
batches, through a detector's train step, with the recipe's SGD (or
AdamW), per-step linear warmup and per-epoch decay; ``--test-only`` the
COCO box mAP of a fresh or resumed model on ``val2017/``.

    python -m vision_tpu_torch.references.detection.train \\
        --model maskrcnn_resnet50_fpn --with-masks --amp --data-path COCO

runs on the card unless ``--device cpu``. A training sample goes
``get_coco`` (decode, polygon fill) -> ``DetectionPresetTrain`` (on the
device) -> ``GroupedBatchSampler`` (aspect-ratio groups read from the
index) -> ``collate_detection(..., max_boxes=--max-boxes)``, which pads
the batch to the model's transform (short side ``--size``, long side at
most ``--size * 1333 / 800``) -> ``make_detection_train_step``. The JAX
recipe pastes each image on its group's canvas before the preset, so that
the policies that change a sample's size cannot batch; here collation
comes after the preset and every policy batches. ``--weights`` names a
state-dict file on disk; nothing is downloaded. ``main(args)`` returns
the steps' losses and times, the host's share and the evaluator's
metrics, for a caller in the same process.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.models import get_model
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
from vision_tpu_torch.ops import misc
from vision_tpu_torch.parallel import (
    DetectionPresetEval,
    DetectionPresetTrain,
    collate_detection,
    make_detection_train_step,
)
from vision_tpu_torch.parallel.presets import COCO_PERSON_KEYPOINT_FLIP_INDICES
from vision_tpu_torch.references.classification import utils
from vision_tpu_torch.references.detection.coco_utils import get_coco
from vision_tpu_torch.references.detection.engine import (
    evaluate_detection,
    train_one_epoch,
)
from vision_tpu_torch.references.detection.group_by_aspect_ratio import (
    GroupedBatchSampler,
    create_aspect_ratio_groups,
)

__all__ = ["WarmupLR", "epoch_lr", "get_args_parser", "main", "make_optimizer"]

ONE_STAGE = ("retinanet", "ssd", "fcos")
NORMS = (misc.BatchNorm2d, misc.GroupNorm, torch.nn.BatchNorm2d, torch.nn.GroupNorm,
         torch.nn.LayerNorm)


def epoch_lr(args, epoch: int) -> float:
    """The epoch's lr (the reference steps ``MultiStepLR`` or
    ``CosineAnnealingLR`` once an epoch, ``train.py:252-260``); the
    per-step warmup multiplies it (``WarmupLR``)."""
    if args.lr_scheduler == "multisteplr":
        return args.lr * args.lr_gamma ** sum(epoch >= m for m in args.lr_steps)
    if args.lr_scheduler == "cosineannealinglr":
        return args.lr * 0.5 * (1.0 + math.cos(math.pi * epoch / args.epochs))
    raise ValueError(f"unknown scheduler {args.lr_scheduler}")


class WarmupLR:
    """Each step's lr: the epoch's (``set_epoch_lr``) times the linear
    warmup factor ``1/1000 + (1 - 1/1000) * min(step / warmup_iters, 1)``
    at the count of steps taken (``engine.py:12``; the JAX recipe's
    ``scale_by_schedule``)."""

    def __init__(self, optimizer, warmup_iters: int, lr: float):
        self.optimizer = optimizer
        self.warmup_iters = warmup_iters
        self.count = 0
        self.set_epoch_lr(lr)

    def factor(self) -> float:
        frac = min(self.count / max(self.warmup_iters, 1), 1.0)
        return 1.0 / 1000 + (1.0 - 1.0 / 1000) * frac

    def set_epoch_lr(self, lr: float) -> None:
        self.lr = lr
        self._apply()

    def step(self) -> None:
        self.count += 1
        self._apply()

    def _apply(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr * self.factor()


def make_optimizer(args, model: torch.nn.Module) -> torch.optim.Optimizer:
    """``--opt`` over the trainable parameters: SGD with momentum and the
    weight decay added to the gradient (``optax.add_decayed_weights``
    before ``sgd``), or AdamW (the decay decoupled); with
    ``--norm-weight-decay``, the normalisation layers' parameters in a
    group of their own with that decay."""
    norm_ids = {id(p) for m in model.modules() if isinstance(m, NORMS)
                for p in m.parameters(recurse=False)}
    params = [p for p in model.parameters() if p.requires_grad]
    wd, nwd = args.weight_decay, args.norm_weight_decay
    if nwd is None or nwd == wd:
        groups = [{"params": params, "weight_decay": wd}]
    else:
        groups = [{"params": [p for p in params if id(p) not in norm_ids],
                   "weight_decay": wd},
                  {"params": [p for p in params if id(p) in norm_ids],
                   "weight_decay": nwd}]
        groups = [g for g in groups if g["params"]]
    if args.opt == "sgd":
        return torch.optim.SGD(groups, lr=args.lr, momentum=args.momentum)
    if args.opt == "adamw":
        return torch.optim.AdamW(groups, lr=args.lr)
    raise ValueError(f"unknown optimizer {args.opt}")


def model_transform(args, device) -> GeneralizedRCNNTransform:
    """The canvas the batches are padded to: the model's fixed transform
    where it has one (SSD, SSDlite), else short side ``--size``, long side
    at most ``--size * 1333 / 800`` (the JAX recipe's group canvases'
    bounds), on a square canvas of the latter rounded up to 32."""
    from vision_tpu_torch.tools.detection_request import TRANSFORMS

    if args.model in TRANSFORMS:
        return GeneralizedRCNNTransform(**TRANSFORMS[args.model], device=device)
    return GeneralizedRCNNTransform(
        min_size=args.size, max_size=int(round(args.size * 1333 / 800)),
        device=device)


def _tv_sample(img: torch.Tensor, t: dict, max_boxes: int, masks: bool,
               keypoints: bool):
    """``get_coco``'s sample as the preset takes it: the first
    ``max_boxes`` rows (the JAX recipe cuts before its preset too)."""
    hw = tuple(img.shape[-2:])
    target = {"boxes": tv.BoundingBoxes(t["boxes"][:max_boxes], format="XYXY",
                                        canvas_size=hw),
              "labels": t["labels"][:max_boxes]}
    if masks:
        target["masks"] = tv.Mask(t["masks"][:max_boxes])
    if keypoints:
        if "keypoints" not in t:
            raise ValueError("--with-keypoints needs a keypoint annotation file "
                             "(person_keypoints_*.json)")
        target["keypoints"] = tv.KeyPoints(t["keypoints"][:max_boxes],
                                           canvas_size=hw)
    return tv.Image(img), target


def coco_batches(args, ds, transform, device, epoch: int,
                 host: Dict[str, float]) -> Iterator[dict]:
    """One epoch of train batches from ``get_coco``'s dataset: the order a
    permutation of ``numpy.random.RandomState(epoch)`` (the JAX recipe's),
    batched by ``GroupedBatchSampler`` over ``--aspect-ratio-group-factor``
    groups (consecutive with 0); each sample through
    ``DetectionPresetTrain`` on ``device``, its draws from a CPU generator
    seeded with ``--seed`` and the epoch; ``collate_detection``. Adds the
    host's seconds to ``host`` (``decode``: the index and the image,
    ``rasterise``: the target and its masks, ``preset``, ``collate``;
    ``samples``)."""
    order = np.random.RandomState(epoch).permutation(len(ds)).tolist()
    k = args.aspect_ratio_group_factor
    if k > 0:
        batches = iter(GroupedBatchSampler(
            order, create_aspect_ratio_groups(ds, k=k), args.batch_size))
    else:
        batches = (order[i:i + args.batch_size] for i in
                   range(0, len(order) - args.batch_size + 1, args.batch_size))
    preset = DetectionPresetTrain(
        data_augmentation=args.data_augmentation,
        keypoint_flip_indices=(COCO_PERSON_KEYPOINT_FLIP_INDICES
                               if args.with_keypoints else None),
        device=device)
    gen = torch.Generator().manual_seed(args.seed * 1000 + epoch)
    for indices in batches:
        samples = []
        for idx in indices:
            t0 = time.perf_counter()
            img, anno = ds.base[int(idx)]
            t1 = time.perf_counter()
            img, t = ds.convert(img, {"image_id": ds.ids[int(idx)],
                                      "annotations": anno})
            t2 = time.perf_counter()
            samples.append(preset(_tv_sample(img, t, args.max_boxes,
                                             args.with_masks,
                                             args.with_keypoints), gen))
            host["decode"] += t1 - t0
            host["rasterise"] += t2 - t1
            host["preset"] += time.perf_counter() - t2
            host["samples"] += 1
        t0 = time.perf_counter()
        batch = collate_detection(samples, transform, max_boxes=args.max_boxes)
        host["collate"] += time.perf_counter() - t0
        yield batch


def fake_batches(args, steps: int, device, seed: int = 0) -> Iterator[dict]:
    """The JAX recipe's fake batches (``train.py:_fake_batches``: the same
    numpy draws), channels first, on ``device``."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        n, g, s = args.batch_size, args.max_boxes, args.size
        x1 = rng.uniform(0, s / 2, (n, g, 1))
        y1 = rng.uniform(0, s / 2, (n, g, 1))
        bw = rng.uniform(4, s / 2, (n, g, 1))
        bh = rng.uniform(4, s / 2, (n, g, 1))
        batch = {
            "image": rng.rand(n, s, s, 3).astype(np.float32).transpose(0, 3, 1, 2),
            "boxes": np.concatenate([x1, y1, np.minimum(x1 + bw, s),
                                     np.minimum(y1 + bh, s)], -1).astype(np.float32),
            "labels": rng.randint(1, args.num_classes, (n, g)).astype(np.int64),
            "valid": rng.rand(n, g) < 0.7,
        }
        if args.with_masks:
            batch["masks"] = (rng.rand(n, g, s, s) > 0.5).astype(np.float32)
        if args.with_keypoints:
            batch["keypoints"] = np.concatenate([
                x1[..., None] + bw[..., None] * rng.rand(n, g, 17, 1),
                y1[..., None] + bh[..., None] * rng.rand(n, g, 17, 1),
                np.ones((n, g, 17, 1))], -1).astype(np.float32)
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batch.items()}


def coco_ground_truths(ds) -> Dict[int, dict]:
    """Every image's annotations from the index, crowd ones included
    (``iscrowd``), boxes XYXY: the JAX recipe's ``_coco_eval_data``."""
    gts = {}
    for img_id in ds.ids:
        annos = ds.coco.loadAnns(ds.coco.getAnnIds(imgIds=img_id))
        boxes = [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                  a["bbox"][1] + a["bbox"][3]] for a in annos]
        gts[img_id] = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray([a["category_id"] for a in annos], np.int64),
            "iscrowd": np.asarray([a.get("iscrowd", 0) for a in annos], np.int64),
        }
    return gts


def run_coco_eval(args, model, transform, device) -> dict:
    """``--test-only``: the box mAP over ``val2017/`` (reference
    ``engine.py:76``): images through ``DetectionPresetEval`` and the
    transform the model trained at, the detections mapped back to each
    image (``postprocess_boxes``), ``evaluate_detection``. Returns the
    metrics with ``images`` and ``seconds``."""
    from vision_tpu_torch.datasets.coco import CocoDetection

    ds = CocoDetection(os.path.join(args.data_path, "val2017"),
                       os.path.join(args.data_path, "annotations",
                                    "instances_val2017.json"))
    gts = coco_ground_truths(ds)
    preset = DetectionPresetEval(device=device)
    one_stage = any(s in args.model for s in ONE_STAGE)

    def batches():
        for i in range(0, len(ds), args.batch_size):
            idx = range(i, min(i + args.batch_size, len(ds)))
            raw = [ds[j][0] for j in idx]
            batch = transform([preset(r) for r in raw])
            yield ([ds.ids[j] for j in idx], batch.tensors, batch.image_sizes,
                   [tuple(r.shape[-2:]) for r in raw])

    @torch.inference_mode()
    def forward(canvas):
        if one_stage:
            return model.postprocess_detections(*model(canvas),
                                                tuple(canvas.shape[-2:]))
        return model(canvas)

    model.eval()
    t0 = time.perf_counter()
    metrics = evaluate_detection(forward, batches(), gts,
                                 transform.postprocess_boxes)
    seconds = time.perf_counter() - t0
    print({k: round(float(v), 4) for k, v in metrics.items()})
    return dict(metrics, images=len(ds), seconds=seconds)


def _load_state(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no weights file {path} (nothing is downloaded)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state.get("model", state)


def main(args, hooks: Optional[Dict[str, Callable]] = None) -> dict:
    """Train (or with ``--test-only`` evaluate) as the flags say. Returns
    ``{"steps": [{"losses", "ms"}], "host": seconds by stage and samples,
    "epoch_s": each epoch's wall seconds (its hooks' included),
    "images_kept": training images after the empty-annotation filter,
    "metrics": the evaluator's (``--test-only``)}``. ``hooks`` are
    ``engine.train_one_epoch``'s, each called with the model first."""
    print(args)
    device = resolve_device(args.device)
    kwargs = {"num_classes": args.num_classes}
    if args.rpn_score_thresh is not None:
        kwargs["rpn_score_thresh"] = args.rpn_score_thresh
    model = get_model(args.model, device=device, seed=args.seed,
                      trainable_backbone_layers=args.trainable_backbone_layers,
                      **kwargs)
    if args.weights:
        model.load_state_dict(_load_state(args.weights))
    elif args.weights_backbone:
        missing, _ = model.backbone.body.load_state_dict(
            _load_state(args.weights_backbone), strict=False)
        if missing:
            raise RuntimeError(f"--weights-backbone lacks {missing}")
    transform = model_transform(args, device)
    optimizer = make_optimizer(args, model)
    warmup = WarmupLR(optimizer, args.warmup_iters, epoch_lr(args, 0))
    start_epoch = args.start_epoch
    if args.resume:
        ckpt = utils.load_checkpoint(args.resume)
        model.load_state_dict(ckpt["model"])
        if "optimizer" in ckpt:
            optimizer.load_state_dict(ckpt["optimizer"])
            warmup.count = int(ckpt["step"])
        start_epoch = int(ckpt["epoch"]) + 1
    if args.test_only:
        return {"metrics": run_coco_eval(args, model, transform, device)}

    one_stage = any(s in args.model for s in ONE_STAGE)
    step_fn = make_detection_train_step(
        model, optimizer, compute_dtype=torch.bfloat16 if args.amp else None,
        one_stage=one_stage)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    ds = None if args.fake_data else get_coco(
        args.data_path, "train", with_masks=args.with_masks)
    host = dict.fromkeys(("decode", "rasterise", "preset", "collate", "samples"), 0)
    hooks = {k: (lambda f: (lambda *a: f(model, *a)))(f)
             for k, f in (hooks or {}).items()}
    steps: List[dict] = []
    epoch_s: List[float] = []
    for epoch in range(start_epoch, args.epochs):
        warmup.set_epoch_lr(epoch_lr(args, epoch))
        if args.fake_data:
            data = fake_batches(args, args.steps_per_epoch or 100, device,
                                seed=epoch)
        else:
            data = coco_batches(args, ds, transform, device, epoch, host)
            if args.steps_per_epoch:
                data = (b for _, b in zip(range(args.steps_per_epoch), data))
        t0 = time.perf_counter()
        steps += train_one_epoch(step_fn, data, generator, epoch,
                                 print_freq=args.print_freq, lr_scheduler=warmup,
                                 hooks=hooks if epoch == start_epoch else None)
        epoch_s.append(time.perf_counter() - t0)
        print(f"epoch {epoch} done in {epoch_s[-1]:.1f}s")
        if args.output_dir:
            utils.save_checkpoint(
                os.path.join(args.output_dir, f"checkpoint_{epoch}.pth"),
                {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                 "epoch": epoch, "step": warmup.count, "args": vars(args)})
    return {"steps": steps, "host": host, "epoch_s": epoch_s,
            "images_kept": None if ds is None else len(ds)}


def get_args_parser() -> argparse.ArgumentParser:
    """The JAX recipe's flags and defaults (``train.py:533-633``), and
    ``--device``."""
    p = argparse.ArgumentParser(description="vision_tpu_torch detection training")
    p.add_argument("--data-path", default="/data/coco", type=str)
    p.add_argument("--model", default="retinanet_resnet50_fpn", type=str)
    p.add_argument("--num-classes", default=91, type=int)
    p.add_argument("--batch-size", default=2, type=int)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute with f32 master weights and f32 box "
                   "arithmetic (reference --amp, detection/train.py:167)")
    p.add_argument("--max-boxes", default=32, type=int)
    p.add_argument("--with-masks", action="store_true",
                   help="carry instance masks and train the mask branch "
                   "(maskrcnn_* models)")
    p.add_argument("--with-keypoints", action="store_true",
                   help="carry keypoints and train the keypoint branch "
                   "(keypointrcnn_* models)")
    p.add_argument("--epochs", default=26, type=int)
    p.add_argument("--steps-per-epoch", default=None, type=int)
    p.add_argument("--opt", default="sgd", type=str, choices=("sgd", "adamw"))
    p.add_argument("--lr", default=0.02, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", "--wd", dest="weight_decay", default=1e-4,
                   type=float)
    p.add_argument("--norm-weight-decay", default=None, type=float,
                   help="weight decay of the normalisation layers' parameters; "
                   "None: --weight-decay")
    p.add_argument("--lr-scheduler", default="multisteplr", type=str,
                   choices=("multisteplr", "cosineannealinglr"))
    p.add_argument("--lr-steps", default=[16, 22], nargs="+", type=int,
                   help="multisteplr epoch milestones")
    p.add_argument("--lr-gamma", default=0.1, type=float)
    p.add_argument("--warmup-iters", default=1000, type=int)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--trainable-backbone-layers", default=None, type=int,
                   help="train only the last N trunk stages; None: all")
    p.add_argument("--rpn-score-thresh", default=None, type=float,
                   help="rpn score threshold for eval (rcnn families)")
    p.add_argument("--weights", default=None, type=str,
                   help="a state-dict file of the whole detector, on disk")
    p.add_argument("--weights-backbone", default=None, type=str,
                   help="a state-dict file of the classification trunk, on disk")
    p.add_argument("--dataset", default="coco", type=str, choices=("coco",),
                   help="accepted for the reference CLI's sake (COCO)")
    p.add_argument("--sync-bn", action="store_true",
                   help="accepted for the reference CLI's sake: one device")
    p.add_argument("--use-deterministic-algorithms", action="store_true",
                   help="accepted for the reference CLI's sake; not applied")
    p.add_argument("--print-freq", default=20, type=int)
    p.add_argument("--output-dir", default=None, type=str)
    p.add_argument("--size", default=640, type=int)
    p.add_argument("--aspect-ratio-group-factor", default=3, type=int,
                   help="2k+1 log-spaced aspect bins in [0.5, 2]; 0 disables "
                   "grouping")
    p.add_argument("--data-augmentation", default="hflip", type=str,
                   help="hflip | lsj | multiscale | ssd | ssdlite")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--fake-data", action="store_true")
    p.add_argument("--test-only", action="store_true",
                   help="COCO val mAP only (engine.evaluate_detection)")
    p.add_argument("--device", default=None, type=str,
                   help="cuda (the default) or cpu")
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
