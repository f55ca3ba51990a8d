"""The reference recipes of the port (counterpart of the repo's
``references/``, which drive the JAX package): the detection and
segmentation trainers with their datasets' plumbing and evaluators, and
the training utilities they share. Each trainer runs as a module::

    python -m vision_tpu_torch.references.detection.train --fake-data ...
    python -m vision_tpu_torch.references.segmentation.train --fake-data ...
"""
