"""The block-compressed textures (``unmicst_tpu_torch/io/bcn.py``, its
native ``native/bcndec.cpp``, and the DDS and FTEX readers over them)
against PIL 12.1's ``BcnDecode.c``, which the JAX package reaches
through ``Image.open`` in its TIFF fallback and its toolbox's
``imread``.

Every decoder (BC1-BC5, BC5S, BC6H, BC6HS, BC7) over seeded random
blocks in DDS files (by fourcc and by DX10 name) and in FTEX files gives
PIL's array through both toolboxes' ``imread`` and both
``read_channel``s, with and without the native library; the native
decoder equals the plain one block for block; the cases PIL's decoder
pins (BC7's block without a mode bit, BC6H's reserved modes and its
half-float scaling, BC5S's signed endpoints, DXT1's three-colour block)
read as PIL reads them; data that hold fewer blocks than the image raise
PIL's ``OSError``.
"""

import io
import os
import struct
import importlib.util

import numpy as np
import pytest
from PIL import Image

from unmicst_tpu.io import slides as jax_slides
from unmicst_tpu.utils import imtools as J
from unmicst_tpu_torch.io import _native, bcn, identify, slides
from unmicst_tpu_torch.utils import imtools as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "icons_make", os.path.join(REPO, "tests", "fixtures", "torch_icons",
                               "make.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

# variant -> (decoder, signed, how the DDS names it)
VARIANTS = {
    "dxt1": (1, False, b"DXT1"), "dxt3": (2, False, b"DXT3"),
    "dxt5": (3, False, b"DXT5"), "bc4u": (4, False, b"BC4U"),
    "ati1": (4, False, b"ATI1"), "bc5u": (5, False, b"BC5U"),
    "ati2": (5, False, b"ATI2"), "bc5s": (5, True, b"BC5S"),
    "dx10_bc1": (1, False, 71), "dx10_bc2": (2, False, 74),
    "dx10_bc3": (3, False, 77), "dx10_bc4": (4, False, 80),
    "dx10_bc5": (5, False, 83), "dx10_bc5s": (5, True, 84),
    "dx10_bc6h": (6, False, 95), "dx10_bc6hs": (6, True, 96),
    "dx10_bc7": (7, False, 98), "dx10_bc7_typeless": (7, False, 97),
    "ftex_dxt1": (1, False, None),
}


def _blocks(rng, n: int, decoder: int) -> np.ndarray:
    """``n`` seeded blocks, with the fields PIL tells apart spread: DXT1's
    endpoint order both ways, every BC6H mode byte, BC7's mode bits and
    some blocks without one."""
    size = 8 if decoder in (1, 4) else 16
    blocks = rng.randint(0, 256, (n, size)).astype(np.uint8)
    if decoder == 1:
        blocks[::2, :2], blocks[::2, 2:4] = (blocks[::2, 2:4].copy(),
                                             blocks[::2, :2].copy())
        blocks[1::7, 2:4] = blocks[1::7, :2]  # c0 == c1
    elif decoder == 6:
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | (np.arange(n) % 32)
    elif decoder == 7:
        blocks[:, 0] = (blocks[:, 0] & ~np.uint8(0xFF >> (np.arange(n) % 8))
                        ) | (0x80 >> (np.arange(n) % 8))
        blocks[::11, 0] = 0
    return blocks


def _file(variant: str, w: int, h: int, blocks: np.ndarray) -> bytes:
    _, _, name = VARIANTS[variant]
    if name is None:
        return mk.ftex(w, h, 0, blocks.tobytes())
    if isinstance(name, bytes):
        return mk.dds(w, h, blocks.tobytes(), name)
    return mk.dds(w, h, blocks.tobytes(), dxgi=name)


def _outcome(fn):
    try:
        r = fn()
        return ("ok", r.dtype.str, r.shape, r.tobytes())
    except OSError:
        return "OSError"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


@pytest.mark.parametrize("codecs", ["native", "python"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_decoder_reads_as_pil(variant, codecs, tmp_path, monkeypatch):
    """Seeded random blocks of each decoder at a size that is no multiple
    of 4 (and one that is): PIL's array through ``identify.read``, both
    toolboxes' ``imread`` and both ``read_channel``s under a TIFF name,
    with and without the native library."""
    assert _native.get_lib() is not None, "the native library did not load"
    if codecs == "python":
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    decoder = VARIANTS[variant][0]
    rng = np.random.RandomState(sum(variant.encode()))
    for w, h in ((37, 22), (16, 8)):
        n = ((w + 3) // 4) * ((h + 3) // 4)
        data = _file(variant, w, h, _blocks(rng, n, decoder))
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = identify.read(data, None, variant)
        assert got.dtype == want.dtype and np.array_equal(got, want), (w, h)
        raw, tif = tmp_path / f"{variant}.dds", tmp_path / f"{variant}.tif"
        raw.write_bytes(data)
        tif.write_bytes(data)
        assert _outcome(lambda: T.imread(str(raw))) == \
            _outcome(lambda: J.imread(str(raw)))
        for ch in (0, 1):
            assert _outcome(lambda: slides.read_channel(str(tif), "tif", ch)) \
                == _outcome(lambda: jax_slides.read_channel(str(tif), "tif",
                                                            ch)), ch


@pytest.mark.parametrize("decoder,signed", [(1, False), (2, False),
                                            (3, False), (4, False),
                                            (5, False), (5, True), (6, False),
                                            (6, True), (7, False)])
def test_native_equals_plain(decoder, signed):
    """``native/bcndec.cpp`` against :func:`bcn.decode_blocks_py` on 4,096
    random blocks: the same 64 bytes a block."""
    assert _native.get_lib() is not None, "the native library did not load"
    rng = np.random.RandomState(decoder * 2 + signed)
    blocks = _blocks(rng, 4096, decoder)
    native = _native.bcn_decode(blocks, decoder, signed)
    plain = bcn.decode_blocks_py(blocks, decoder, signed)
    assert native.dtype == plain.dtype == np.uint8
    assert np.array_equal(native, plain)


def _one_block(data: bytes, variant: str, w: int = 4, h: int = 4):
    """PIL's and the port's reads of one block."""
    f = _file(variant, w, h, np.frombuffer(data, np.uint8)[None])
    return np.asarray(Image.open(io.BytesIO(f))), identify.read(f, None, "x")


def test_pinned_blocks_read_as_pil():
    """The blocks whose outcome PIL's decoder decides: BC7 without a mode
    bit (opaque black), each BC6H reserved mode (black) and a BC6H block
    per mode of flat endpoints at values around 1.0 (the half float times
    255, truncated), BC5S's endpoints at -128, -1, 0 and 127, and DXT1's
    three-colour block with its transparent fourth colour."""
    cases = [(bytes(16), "dx10_bc7")]
    for mode in (0x13, 0x17, 0x1B, 0x1F):
        cases.append((bytes([mode]) + bytes(range(1, 16)), "dx10_bc6h"))
    for v in (0x3B00, 0x3BFF, 0x3C00, 0x7BFF, 0x0001):
        for variant in ("dx10_bc6h", "dx10_bc6hs"):
            # mode 11 (00011): 10-bit endpoints, one subset
            bits = [1, 1, 0, 0, 0] + [(v >> 6 >> i) & 1 for i in range(10)] * 6
            b = np.packbits(np.array(bits + [0] * (128 - len(bits)),
                                     np.uint8), bitorder="little").tobytes()
            cases.append((b, variant))
    for a0, a1 in ((0x80, 0x7F), (0xFF, 0x00), (0x00, 0xFF), (0x7F, 0x80)):
        half = bytes([a0, a1, 0x88, 0xC6, 0xFA, 0x05, 0x39, 0xA7])
        cases.append((half + half[::-1], "bc5s"))
    cases.append((struct.pack("<HHI", 0x1234, 0xF00F, 0xE4E4E4E4), "dxt1"))
    for data, variant in cases:
        want, got = _one_block(data, variant)
        assert got.dtype == want.dtype and np.array_equal(got, want), (
            variant, data.hex())


@pytest.mark.parametrize("variant", ["dxt1", "dxt5", "dx10_bc6h",
                                     "dx10_bc7", "ftex_dxt1"])
def test_data_short_of_the_last_block_raise_pils_oserror(variant, tmp_path):
    """Data one byte, a block, or everything short of the image: PIL's
    ``OSError`` (image file is truncated), from ``identify.read`` and
    both toolboxes' ``imread``."""
    decoder = VARIANTS[variant][0]
    rng = np.random.RandomState(7)
    data = _file(variant, 9, 6, _blocks(rng, 6, decoder))
    size = 8 if decoder in (1, 4) else 16
    for cut in (1, size, 6 * size):
        short = data[:-cut]
        path = tmp_path / "t.dds"
        path.write_bytes(short)
        with pytest.raises(OSError, match="truncated"):
            identify.read(short, None, variant)
        assert _outcome(lambda: T.imread(str(path))) == \
            _outcome(lambda: J.imread(str(path))) == "OSError"


def test_bc4s_stays_pils_refusal(tmp_path):
    """A ``BC4S`` fourcc, which PIL names and does not open: its
    ``NotImplementedError`` (Unimplemented pixel format) from both
    ``imread``s."""
    data = mk.dds(4, 4, bytes(8), b"BC4S")
    path = tmp_path / "s.dds"
    path.write_bytes(data)
    assert _outcome(lambda: T.imread(str(path))) == \
        _outcome(lambda: J.imread(str(path))) == "NotImplementedError"
