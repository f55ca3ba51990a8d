"""Build system (the reference's ``setup.py``/CMake slot, SURVEY.md L9).

Packages vision_tpu and builds the native codec extension
(``csrc/image_codecs.cpp`` -> libvtpu_codecs.so). The extension also
self-builds on first import, so `pip install -e .` and source checkouts
both work.
"""

import subprocess
import sys
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithCodecs(build_py):
    def run(self):
        src = Path(__file__).parent / "vision_tpu" / "csrc" / "image_codecs.cpp"
        out = src.parent / "libvtpu_codecs.so"
        try:
            subprocess.run(
                [
                    "g++", "-O2", "-shared", "-fPIC", str(src), "-o", str(out),
                    "-ljpeg", "-lpng", "-lwebp",
                ],
                check=True,
            )
        except Exception as e:  # PIL fallback keeps the package usable
            print(f"warning: native codec build failed ({e})", file=sys.stderr)
        super().run()


setup(
    name="vision_tpu",
    version="0.1.0",
    description=(
        "TPU-native computer vision framework (JAX/XLA/Pallas) with the "
        "capabilities of torchvision"
    ),
    packages=find_packages(
        include=["vision_tpu", "vision_tpu.*", "vision_tpu_torch",
                 "vision_tpu_torch.*"]
    ),
    package_data={
        "vision_tpu": ["csrc/*.cpp", "csrc/*.so"],
        # CUDA sources, built with nvcc on first use on a GPU host, and the
        # codecs' C++, built with g++ on first use
        "vision_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={
        "io": ["pillow"],
        "train": ["orbax-checkpoint"],
    },
    cmdclass={"build_py": BuildWithCodecs},
)
