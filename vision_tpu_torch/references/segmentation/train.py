"""The semantic-segmentation trainer (the port's copy of the repo's
``references/segmentation/train.py``; reference
``references/segmentation/train.py``): VOC from files, or seeded fake
batches, through ``parallel.make_segmentation_train_step`` (the
cross-entropy of ``out`` plus half that of ``aux``, 255 ignored), SGD
with a linear or constant warmup and the poly (0.9) decay a step, and the
confusion matrix's global accuracy and mean IoU on ``val`` after each
epoch (or alone with ``--test-only``).

    python -m vision_tpu_torch.references.segmentation.train \\
        --model deeplabv3_resnet50 --data-path VOC --size 480 --batch-size 8

runs on the card unless ``--device cpu``. A training sample goes
``VOCSegmentation`` (decode, palette indices) -> ``SegmentationPresetTrain``
(on the device, its draws from a CPU generator); an eval sample is
resized (short side ``--size``) and centre-cropped to ``--size`` square
(``_voc_sample``). ``main(args)`` returns the steps' losses and times and
the evaluation, for a caller in the same process.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from vision_tpu_torch.models import get_model
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.parallel import (
    SegmentationPresetTrain,
    make_segmentation_train_step,
)
from vision_tpu_torch.references.classification import utils
from vision_tpu_torch.transforms.v2 import functional as F

__all__ = ["ConfusionMatrix", "evaluate", "get_args_parser", "main",
           "poly_lr_schedule"]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class ConfusionMatrix:
    """reference ``utils.py`` ConfusionMatrix: the ``(C, C)`` counts of
    (ground truth, prediction) pairs whose ground truth is a class (255
    and other values outside ``[0, C)`` are left out); counted on the
    tensors' device, summed on the host in int64."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, target, pred) -> None:
        n = self.num_classes
        t = torch.as_tensor(target).reshape(-1)
        p = torch.as_tensor(pred, device=t.device).reshape(-1)
        k = (t >= 0) & (t < n)
        inds = n * t[k].long() + p[k].long()
        self.mat += torch.bincount(inds, minlength=n * n).reshape(n, n).cpu().numpy()

    def compute(self):
        """Global accuracy, each class's accuracy and IoU (0 for a class
        that is neither in the ground truth nor predicted)."""
        h = self.mat.astype(np.float64)
        acc_global = np.diag(h).sum() / np.maximum(h.sum(), 1)
        acc = np.diag(h) / np.maximum(h.sum(1), 1)
        iou = np.diag(h) / np.maximum(h.sum(1) + h.sum(0) - np.diag(h), 1)
        return acc_global, acc, iou

    def __str__(self) -> str:
        acc_global, _, iou = self.compute()
        return (f"global correct: {acc_global * 100:.1f}\n"
                f"mean IoU: {np.nanmean(iou) * 100:.1f}")


def poly_lr_schedule(base_lr: float, total_steps: int, power: float = 0.9,
                     warmup_iters: int = 0, warmup_decay: float = 0.01,
                     warmup_method: str = "linear") -> Callable[[int], float]:
    """reference ``train.py``: ``SequentialLR(warmup, PolynomialLR)``: the
    warmup (linear from ``warmup_decay`` or constant at it) for the first
    ``warmup_iters`` steps, then ``(1 - t)^power`` decay over the
    remaining ``total_steps - warmup_iters``."""

    def schedule(step: int) -> float:
        decay_steps = max(total_steps - warmup_iters, 1)
        frac = min(max((step - warmup_iters) / decay_steps, 0.0), 1.0)
        lr = base_lr * (1.0 - frac) ** power
        if warmup_iters > 0 and step < warmup_iters:
            if warmup_method == "constant":
                return base_lr * warmup_decay
            return base_lr * (warmup_decay + (1.0 - warmup_decay)
                              * min(step / max(warmup_iters, 1), 1.0))
        return lr

    return schedule


def _fake_batches(args, num_classes: int, steps: int, device,
                  seed: int = 0) -> Iterator[dict]:
    """The JAX recipe's fake batches (the same numpy draws), channels
    first, on ``device``."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        image = rng.rand(args.batch_size, args.size, args.size, 3).astype(np.float32)
        target = rng.randint(0, num_classes, (args.batch_size, args.size, args.size))
        yield {"image": torch.from_numpy(image.transpose(0, 3, 1, 2).copy()).to(device),
               "target": torch.from_numpy(target.astype(np.int64)).to(device)}


def _voc_sample(img: torch.Tensor, mask: torch.Tensor, size: int, device
                ) -> tuple:
    """The eval canvas (``train.py:_voc_sample``): resized so that the short
    side is ``size`` (each side at least ``size``), centre-cropped to
    ``size`` square, normalised; the mask by the nearest pixel."""
    img, mask = img.to(device), mask.to(device)
    h, w = img.shape[-2:]
    scale = size / min(h, w)
    nh, nw = max(int(h * scale), size), max(int(w * scale), size)
    img = F.resize_image(img, [nh, nw])
    mask = F.resize_mask(mask, [nh, nw])
    top, left = (nh - size) // 2, (nw - size) // 2
    img = img[..., top:top + size, left:left + size]
    mask = mask[..., top:top + size, left:left + size]
    x = F.normalize_image(img.float() / 255.0, _MEAN, _STD)
    return x, mask.long()


def _voc_batches(args, split: str, train: bool, device, epoch: int = 0,
                 host: Optional[Dict[str, float]] = None) -> Iterator[dict]:
    """Full batches of ``VOCSegmentation(split)`` (the JAX recipe drops
    the last short one): training in the order of
    ``numpy.random.RandomState(epoch)``'s permutation through
    ``SegmentationPresetTrain(base_size=crop_size=--size)``, its draws
    from a CPU generator seeded with ``--seed`` and the epoch; eval in
    order through ``_voc_sample``. Adds the host's seconds to ``host``
    (``read``, ``preset``, ``samples``)."""
    from vision_tpu_torch.datasets.voc import VOCSegmentation

    host = host if host is not None else dict.fromkeys(("read", "preset", "samples"), 0)
    ds = VOCSegmentation(args.data_path, image_set=split)
    order = (np.random.RandomState(epoch).permutation(len(ds)) if train
             else np.arange(len(ds)))
    preset = (SegmentationPresetTrain(base_size=args.size, crop_size=args.size,
                                      device=device) if train else None)
    gen = torch.Generator().manual_seed(args.seed * 1000 + epoch)
    images, targets = [], []
    for idx in order:
        t0 = time.perf_counter()
        img, mask = ds[int(idx)]
        t1 = time.perf_counter()
        x, t = (preset((img, mask), gen) if train
                else _voc_sample(img, mask, args.size, device))
        host["read"] += t1 - t0
        host["preset"] += time.perf_counter() - t1
        host["samples"] += 1
        images.append(x)
        targets.append(t)
        if len(images) == args.batch_size:
            yield {"image": torch.stack(images), "target": torch.stack(targets)}
            images, targets = [], []


@torch.inference_mode()
def evaluate(model, batches, num_classes: int) -> dict:
    """The confusion matrix of ``out``'s argmax over ``batches``:
    ``{"acc_global", "mean_iou", "iou", "images", "seconds", "confmat"}``."""
    model.eval()
    confmat = ConfusionMatrix(num_classes)
    t0 = time.perf_counter()
    n = 0
    for batch in batches:
        pred = model(batch["image"])["out"].argmax(1)
        confmat.update(batch["target"], pred)
        n += batch["image"].shape[0]
    acc_global, _, iou = confmat.compute()
    print(confmat)
    return {"acc_global": float(acc_global), "mean_iou": float(np.nanmean(iou)),
            "iou": iou.tolist(), "images": n, "seconds": time.perf_counter() - t0,
            "confmat": confmat}


def main(args) -> dict:
    """Train and evaluate (or with ``--test-only`` evaluate) as the flags
    say. Returns ``{"steps": [{"loss", "lr", "ms"}], "host": seconds by
    stage and samples, "epoch_s": each epoch's wall seconds, "eval":
    evaluate's, of the last epoch}``."""
    print(args)
    device = resolve_device(args.device)
    model = get_model(args.model, device=device, seed=args.seed,
                      num_classes=args.num_classes)
    if args.weights:
        if not os.path.isfile(args.weights):
            raise FileNotFoundError(f"no weights file {args.weights} "
                                    "(nothing is downloaded)")
        state = torch.load(args.weights, map_location="cpu", weights_only=True)
        model.load_state_dict(state.get("model", state))
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.SGD(params, lr=args.lr, momentum=args.momentum,
                                weight_decay=args.weight_decay)
    if args.fake_data:
        iters = args.steps_per_epoch or 100
    else:
        from vision_tpu_torch.datasets.voc import VOCSegmentation

        iters = args.steps_per_epoch or len(
            VOCSegmentation(args.data_path, image_set="train")) // args.batch_size
    schedule = poly_lr_schedule(args.lr, iters * args.epochs,
                                warmup_iters=args.lr_warmup_epochs * iters,
                                warmup_decay=args.lr_warmup_decay,
                                warmup_method=args.lr_warmup_method)
    step_fn = make_segmentation_train_step(
        model, optimizer, compute_dtype=torch.bfloat16 if args.amp else None)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    global_step, start_epoch = 0, args.start_epoch
    if args.resume:
        ckpt = utils.load_checkpoint(args.resume)
        model.load_state_dict(ckpt["model"])
        if "optimizer" in ckpt:
            optimizer.load_state_dict(ckpt["optimizer"])
            global_step = int(ckpt["step"])
        start_epoch = int(ckpt["epoch"]) + 1

    def eval_batches():
        if args.fake_data:
            return _fake_batches(args, args.num_classes, 2, device, seed=999)
        return _voc_batches(args, "val", False, device)

    if args.test_only:
        return {"eval": evaluate(model, eval_batches(), args.num_classes)}
    host = dict.fromkeys(("read", "preset", "samples"), 0)
    steps: List[dict] = []
    epoch_s: List[float] = []
    result: dict = {}
    for epoch in range(start_epoch, args.epochs):
        logger = utils.MetricLogger()
        if args.fake_data:
            data = _fake_batches(args, args.num_classes, iters, device, seed=epoch)
        else:
            data = _voc_batches(args, "train", True, device, epoch, host)
            if args.steps_per_epoch:
                data = (b for _, b in zip(range(args.steps_per_epoch), data))
        t_epoch = time.perf_counter()
        for batch in logger.log_every(data, args.print_freq, f"Epoch [{epoch}]"):
            lr = schedule(global_step)
            for group in optimizer.param_groups:
                group["lr"] = lr
            t0 = time.perf_counter()
            loss = float(step_fn(batch, generator)["loss"])
            steps.append({"loss": loss, "lr": lr,
                          "ms": (time.perf_counter() - t0) * 1e3})
            logger.update(loss=loss)
            global_step += 1
        epoch_s.append(time.perf_counter() - t_epoch)
        print(f"epoch {epoch} done in {epoch_s[-1]:.1f}s")
        result = evaluate(model, eval_batches(), args.num_classes)
        if args.output_dir:
            utils.save_checkpoint(
                os.path.join(args.output_dir, f"checkpoint_{epoch}.pth"),
                {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                 "epoch": epoch, "step": global_step, "args": vars(args)})
    return {"steps": steps, "host": host, "epoch_s": epoch_s, "eval": result}


def get_args_parser() -> argparse.ArgumentParser:
    """The JAX recipe's flags and defaults (``train.py:375-423``), and
    ``--device``."""
    p = argparse.ArgumentParser(description="vision_tpu_torch segmentation training")
    p.add_argument("--data-path", default="/data/voc", type=str)
    p.add_argument("--model", default="fcn_resnet50", type=str)
    p.add_argument("--num-classes", default=21, type=int)
    p.add_argument("--aux-loss", action="store_true", default=True,
                   help="the auxiliary head's loss at half weight (the port's "
                   "models always carry that head)")
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute with f32 master weights (reference --amp)")
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--steps-per-epoch", default=None, type=int)
    p.add_argument("--lr", default=0.01, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", "--wd", dest="weight_decay", default=1e-4,
                   type=float)
    p.add_argument("--lr-warmup-epochs", default=0, type=int)
    p.add_argument("--lr-warmup-method", default="linear", type=str,
                   choices=("linear", "constant"))
    p.add_argument("--lr-warmup-decay", default=0.01, type=float)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--test-only", action="store_true",
                   help="evaluate mIoU of the (resumed) model and exit")
    p.add_argument("--weights", default=None, type=str,
                   help="a state-dict file of the whole model, on disk")
    p.add_argument("--use-deterministic-algorithms", action="store_true",
                   help="accepted for the reference CLI's sake; not applied")
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--output-dir", default=None, type=str)
    p.add_argument("--size", default=480, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--fake-data", action="store_true")
    p.add_argument("--device", default=None, type=str,
                   help="cuda (the default) or cpu")
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
