"""Image IO of the port (counterpart of ``vision_tpu/io``): JPEG through
the port's own codec, decoded on the host or with its IDCT tail on the
card, and a pinned prefetch queue to the card."""

from vision_tpu_torch.io.image import (
    ImageReadMode,
    decode_image,
    decode_jpeg,
    encode_jpeg,
    read_file,
    read_image,
    write_file,
    write_jpeg,
)
from vision_tpu_torch.io.jpeg_device import decode_coefs, decode_jpeg_batch_device
from vision_tpu_torch.io.prefetch import (
    PrefetchIterator,
    decode_batch,
    prefetch_to_device,
)

__all__ = [
    "ImageReadMode",
    "PrefetchIterator",
    "decode_batch",
    "decode_coefs",
    "decode_image",
    "decode_jpeg",
    "decode_jpeg_batch_device",
    "encode_jpeg",
    "prefetch_to_device",
    "read_file",
    "read_image",
    "write_file",
    "write_jpeg",
]
