"""HDF5 scene shard → `.npy` scene store:

    python -m lara_tpu_torch.tools.h5_to_store SRC.h5 DST_DIR

Writes every dataset of the shard, at any depth, as `DST_DIR/<path>.npy`
(`scene_0000/image_3` → `DST_DIR/scene_0000/image_3.npy`,
`scene_0000/groups/groups_4_1` → `.../groups/groups_4_1.npy`, a
`splits/test` list → `DST_DIR/splits/test.npy`): the layout that
`data/gobjverse.py:NpyStore` reads, so `GObjaverseDataset` serves the same
samples from either store. Arrays are copied as they are, except that
variable-length strings become fixed-length bytes (`.npy` without
pickles), which read back as the same `str` values. Runs where h5py is
installed (the GPU machine has none: convert elsewhere, copy the
directory). The store is written beside DST_DIR and renamed into place
when whole; an existing DST_DIR raises.
`eval_all`'s fixed `.h5` paths take such a directory under the same name,
since `open_store` reads any directory as an `NpyStore`.
"""

from __future__ import annotations

import argparse
import os
import shutil


def convert(src: str, dst: str) -> int:
    """Write `src`'s datasets into the new store directory `dst`; returns
    the number of arrays written."""
    import h5py
    import numpy as np

    dst = os.path.normpath(dst)
    if os.path.exists(dst):
        raise FileExistsError(f"{dst} exists; h5_to_store writes a new directory")
    tmp = f"{dst}.tmp{os.getpid()}"
    names = []

    def write(name, obj):
        if isinstance(obj, h5py.Dataset):
            path = os.path.join(tmp, *name.split("/")) + ".npy"
            os.makedirs(os.path.dirname(path), exist_ok=True)
            arr = np.asarray(obj[()])
            if arr.dtype.kind == "O":       # variable-length strings: fixed-length bytes
                arr = np.array(arr.tolist(), dtype=bytes)
            np.save(path, arr, allow_pickle=False)
            names.append(name)

    try:
        with h5py.File(src, "r") as f:
            f.visititems(write)
        os.rename(tmp, dst)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return len(names)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the HDF5 shard")
    ap.add_argument("dst", help="the store directory to write (must not exist)")
    args = ap.parse_args(argv)
    n = convert(args.src, args.dst)
    print(f"{args.src} -> {args.dst}: {n} arrays")


if __name__ == "__main__":
    main()
