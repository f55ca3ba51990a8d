"""The detection recipe: COCO plumbing, aspect-ratio batching, the COCO
evaluator, the engine and the trainer."""
