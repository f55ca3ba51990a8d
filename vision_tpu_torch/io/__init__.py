"""Image IO of the port (counterpart of ``vision_tpu/io``): JPEG through
the port's own codec, decoded on the host or with its IDCT tail on the
card, PNG and GIF on the host, a pinned prefetch queue to the card, and
the ImageNet loader that feeds the card from JPEG files
(``DeviceJpegLoader``)."""

from vision_tpu_torch.io.device_loader import DeviceJpegLoader
from vision_tpu_torch.io.image import (
    ImageReadMode,
    decode_gif,
    decode_image,
    decode_jpeg,
    decode_png,
    decode_png16,
    decode_webp,
    encode_jpeg,
    encode_png,
    read_file,
    read_image,
    write_file,
    write_jpeg,
    write_png,
)
from vision_tpu_torch.io.jpeg_device import decode_coefs, decode_jpeg_batch_device
from vision_tpu_torch.io.prefetch import (
    PrefetchIterator,
    decode_batch,
    prefetch_to_device,
)

__all__ = [
    "DeviceJpegLoader",
    "ImageReadMode",
    "PrefetchIterator",
    "decode_batch",
    "decode_coefs",
    "decode_gif",
    "decode_image",
    "decode_jpeg",
    "decode_jpeg_batch_device",
    "decode_png",
    "decode_png16",
    "decode_webp",
    "encode_jpeg",
    "encode_png",
    "prefetch_to_device",
    "read_file",
    "read_image",
    "write_file",
    "write_jpeg",
    "write_png",
]
