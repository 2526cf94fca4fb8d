"""The JAX package's ``utils/util.py``: ``human_format`` and ``Timer`` as
they are, and ``feat_to_fig``, the attention / feature heatmap that
validation logs to TensorBoard, as an RGB array.

The JAX package draws the heatmap with matplotlib (``imshow(feat.T,
aspect="auto", origin="lower", cmap="viridis")``). The port draws the same
pixels without matplotlib and without the axes: the data min-max
normalised as ``imshow``'s default ``Normalize`` does, mapped through
viridis's 256-entry table as ``Colormap(..., bytes=True)`` maps it, and
flipped so that row 0 of the data is the bottom row of the image.
"""
from __future__ import annotations

import time

import numpy as np


def human_format(num: float) -> str:
    magnitude = 0
    while abs(num) >= 1000 and magnitude < 4:
        magnitude += 1
        num /= 1000.0
    return f"{num:.1f}".rstrip("0").rstrip(".") + ["", "K", "M", "G", "T"][magnitude]


class Timer:
    """Wall-clock accumulator used in progress messages."""

    def __init__(self):
        self.prev_t = time.time()
        self.clear()

    def set(self):
        self.prev_t = time.time()

    def cnt(self, mode: str):
        self.time_table[mode] += time.time() - self.prev_t
        self.set()
        if mode == "bw":
            self.click += 1

    def show(self) -> str:
        total = sum(self.time_table.values()) or 1e-8
        msg = " | ".join(f"{k} {v / total:.0%}" for k, v in self.time_table.items())
        self.clear()
        return f"[{msg}]"

    def clear(self):
        self.time_table = {"rd": 1e-6, "fw": 1e-6, "bw": 1e-6}
        self.click = 0


# viridis's 256 colours as 8-bit RGB: matplotlib's ``_viridis_data`` (256
# float triples) times 255, truncated, as its byte lookup table holds them
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"), np.uint8).reshape(256, 3)


def feat_to_fig(feat) -> np.ndarray:
    """Attention / feature heatmap, feat (T, D) or (H, T, D) (the first
    head is drawn) -> (D, T, 3) uint8 RGB: the transposed data, its
    row 0 at the bottom. NaNs are black, as matplotlib's "bad" colour
    (transparent black) on a black ground."""
    x = np.asarray(feat)
    if x.ndim == 3:
        x = x[0]
    x = np.array(x.T, dtype=x.dtype if x.dtype.kind == "f" else
                 np.promote_types(x.dtype, np.float32))
    lo, hi = x.min(), x.max()
    if lo == hi:
        x.fill(0)
    else:
        x -= lo
        x /= hi - lo
    n = len(VIRIDIS)
    x *= n                                   # now in [0, n], or NaN
    x[x == n] = n - 1
    bad = np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    idx[bad] = n
    lut = np.concatenate([VIRIDIS, np.zeros((1, 3), np.uint8)])
    return lut[idx][::-1].copy()
