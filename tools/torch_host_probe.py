#!/usr/bin/env python3
"""Print what a machine offers the port's host data layer: Python packages
for H5 and image decode, and the JPEG / zlib headers and libraries a native
loader would build against (the CUDA toolkit's nvJPEG among them).

    python3 tools/torch_host_probe.py

Probes only: it imports, looks up files and asks the dynamic loader, and
installs nothing.
"""

from __future__ import annotations

import ctypes.util
import glob
import importlib
import json
import shutil


def main() -> None:
    modules = {}
    for name in ("h5py", "cv2", "PIL", "torchvision", "simplejpeg", "turbojpeg", "imageio",
                 "yaml", "scipy"):
        try:
            mod = importlib.import_module(name)
            modules[name] = getattr(mod, "__version__", "present")
        except ImportError as e:
            modules[name] = f"absent ({e})"
    include_dirs = ["/usr/include", "/usr/include/x86_64-linux-gnu", "/usr/local/include",
                    "/usr/local/cuda/include"]
    headers = {h: [d for d in include_dirs if glob.glob(f"{d}/{h}")]
               for h in ("jpeglib.h", "turbojpeg.h", "zlib.h", "png.h", "nvjpeg.h")}
    libraries = {name: ctypes.util.find_library(name)
                 for name in ("jpeg", "turbojpeg", "z", "png", "nvjpeg")}
    libraries["nvjpeg (toolkit)"] = sorted(glob.glob("/usr/local/cuda/lib64/libnvjpeg*"))
    tools = {t: shutil.which(t) for t in ("gcc", "g++", "nvcc", "pkg-config")}
    print(json.dumps({"modules": modules, "headers": headers, "libraries": libraries,
                      "tools": tools}, indent=1))


if __name__ == "__main__":
    main()
