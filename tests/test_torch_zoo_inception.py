"""GoogLeNet and Inception v3, the port against ``vision_tpu`` on the CPU,
the JAX variables carried across by ``load_jax_variables``: GoogLeNet at
97x97, where the ceil-mode pools keep partial windows, Inception v3 at
107x107; each with its auxiliary heads in training mode (GoogLeNet's 6x6
input pooled to 4x4, Inception at 299x299) and ``transform_input`` on.
The auxiliary heads' first Linear reads an HWC flatten in JAX: the
training forward holds the loader's reordering. Forward in f32 with every
named feature and in bf16, the train-mode forward with the running
statistics it leaves, one SGD step (without the auxiliary heads); each
builder's JAX variables placed onto the port's model on the meta device.
Tolerances: ``tests/torch_zoo_cases.py``.
"""

import importlib

import numpy as np
import pytest

from torch_zoo_cases import (
    Pair,
    check_bf16,
    check_forward,
    check_loads_shapes,
    check_sgd_step,
    check_train_forward,
    images,
)
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

jgoog, jinc = (importlib.import_module(f"vision_tpu.models.{m}")
               for m in ("googlenet", "inception"))
tgoog = importlib.import_module("vision_tpu_torch.models.googlenet")
tinc = importlib.import_module("vision_tpu_torch.models.inception")

CASES = {
    "googlenet": (lambda: jgoog.GoogLeNet(num_classes=10, dropout=0.0),
                  lambda: tgoog.GoogLeNet(num_classes=10, dropout=0.0), 97),
    "inception_v3": (lambda: jinc.Inception3(num_classes=10, aux_logits=False,
                                             dropout=0.0),
                     lambda: tinc.Inception3(num_classes=10, aux_logits=False,
                                             dropout=0.0), 107),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    jax_module, port, size = CASES[request.param]
    x = images(2, size, seed=len(request.param))
    return Pair(jax_module(), port, x), x


def test_forward_matches_jax(case):
    check_forward(*case)


def test_bf16_forward_matches_jax(case):
    check_bf16(*case)


def test_sgd_step_matches_jax(case):
    pair, x = case
    labels = np.random.RandomState(6).randint(0, 10, len(x)).astype(np.int32)
    check_sgd_step(pair, x, labels)


@pytest.mark.parametrize("name,size", [("googlenet", 97), ("inception", 299)])
def test_auxiliary_heads_in_training_match_jax(name, size):
    """The train-mode forward: the named tuple of logits and auxiliary
    logits (no dropout), with ``transform_input`` on, and the running
    statistics."""
    if name == "googlenet":
        kw = dict(num_classes=10, aux_logits=True, transform_input=True,
                  dropout=0.0, dropout_aux=0.0)
        module, port_cls = jgoog.GoogLeNet(**kw), tgoog.GoogLeNet
    else:
        kw = dict(num_classes=10, aux_logits=True, transform_input=True,
                  dropout=0.0)
        module, port_cls = jinc.Inception3(**kw), tinc.Inception3
    x = images(2, size, seed=7)
    check_train_forward(Pair(module, lambda: port_cls(**kw), x), x)


@pytest.mark.parametrize("name", ["googlenet", "inception_v3"])
def test_builder_loads_its_jax_variables(name):
    check_loads_shapes(name, name)
