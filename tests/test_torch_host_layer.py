"""The port's own host layer against the JAX package's originals.

``pim_jpeg_decoder_tpu_torch`` carries its own copies of the JAX package's
JAX-free host modules (``codec/``, ``native/``, ``io/``, ``oracle/``,
``ops/specs.py``, ``ops/idct_math.py``, ``utils/``), so it imports nothing
of ``pim_jpeg_decoder_tpu``.  Each copy must behave as its original: on
seeded JPEGs made by each package's encoder in the five colour modes, with
restart markers, and one progressive file (PIL's), the scan fields, the
coefficients of the native and the Python entropy decoders, the encoded
bytes, the oracle's RGB and the BMP bytes are equal.  Tolerance 0: the
layer is integer code.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
from PIL import Image

from pim_jpeg_decoder_tpu.codec import encoder as jax_encoder
from pim_jpeg_decoder_tpu.codec import entropy as jax_entropy
from pim_jpeg_decoder_tpu.codec import progressive as jax_progressive
from pim_jpeg_decoder_tpu.codec import scanner as jax_scanner
from pim_jpeg_decoder_tpu.io import bmp as jax_bmp
from pim_jpeg_decoder_tpu.native import binding as jax_binding
from pim_jpeg_decoder_tpu.native import decode_scan_native as jax_native
from pim_jpeg_decoder_tpu.ops import idct_math as jax_idct_math
from pim_jpeg_decoder_tpu.ops import specs as jax_specs
from pim_jpeg_decoder_tpu.oracle import decoder as jax_oracle
from pim_jpeg_decoder_tpu.utils import config as jax_config
from pim_jpeg_decoder_tpu.utils import profiling as jax_profiling
from pim_jpeg_decoder_tpu_torch.codec import encoder, entropy, progressive
from pim_jpeg_decoder_tpu_torch.codec import scanner
from pim_jpeg_decoder_tpu_torch.io import bmp
from pim_jpeg_decoder_tpu_torch.native import binding, decode_scan_native
from pim_jpeg_decoder_tpu_torch.ops import idct_math, specs
from pim_jpeg_decoder_tpu_torch.oracle import decoder as oracle
from pim_jpeg_decoder_tpu_torch.utils import config, profiling

PORT = os.path.dirname(os.path.dirname(os.path.abspath(binding.__file__)))

# Case -> encoder options (None: PIL's progressive 4:2:0).
CASES = {
    "444": dict(sampling="4:4:4", quality=90),
    "422": dict(sampling="4:2:2", quality=75),
    "440": dict(sampling="4:4:0", quality=75),
    "420": dict(sampling="4:2:0", quality=50),
    "gray": dict(grayscale=True, quality=80),
    "420_dri": dict(sampling="4:2:0", quality=75, restart_interval=3),
    "444_ids_comment": dict(sampling="4:4:4", quality=60,
                            zero_based_ids=True, comment=b"port",
                            app_segments=[b"\xff\xe1\x00\x06Exif"]),
    "progressive": None,
}
BASELINE = [k for k, v in CASES.items() if v is not None]


def photo(seed: int, h: int = 45, w: int = 70) -> np.ndarray:
    """Blocky colour blobs plus noise: every coefficient class in use."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    big = np.kron(small, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(big + rng.normal(0, 12, big.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def blobs():
    """Case -> JPEG bytes (the JAX package's encoder; PIL's for the
    progressive file)."""
    out = {}
    for i, (name, kw) in enumerate(CASES.items()):
        img = photo(i)
        if kw is None:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", progressive=True,
                                      quality=80, subsampling=2)
            out[name] = buf.getvalue()
        else:
            out[name] = jax_encoder.encode_jpeg(img, **kw)
    return out


def plain(x):
    """Dataclasses as dicts and arrays as lists, all the way down: the two
    packages' classes differ, their fields must not."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    return x


@pytest.mark.parametrize("case", BASELINE)
def test_encoder_bytes(case):
    img = photo(100 + len(case))
    assert (encoder.encode_jpeg(img, **CASES[case])
            == jax_encoder.encode_jpeg(img, **CASES[case]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_jpeg_fields(blobs, case):
    got = scanner.scan_jpeg(blobs[case])
    want = jax_scanner.scan_jpeg(blobs[case])
    assert type(got).__module__.startswith("pim_jpeg_decoder_tpu_torch.")
    assert plain(got) == plain(want)
    for prop in ("ncomp", "mcu_cols", "mcu_rows", "num_mcus",
                 "blocks_per_mcu", "mode_key"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.slot_components() == want.slot_components()


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_coefficients(blobs, case):
    got_h = scanner.scan_jpeg(blobs[case])
    want_h = jax_scanner.scan_jpeg(blobs[case])
    if case == "progressive":
        got = progressive.decode_progressive(got_h)
        want = jax_progressive.decode_progressive(want_h)
    else:
        got = decode_scan_native(got_h)
        want = jax_native(want_h)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_coefficients(blobs, case):
    """The pure-Python decoders, the fallback without g++, and equal to the
    native decoder's coefficients."""
    got_h = scanner.scan_jpeg(blobs[case])
    want_h = jax_scanner.scan_jpeg(blobs[case])
    if case == "progressive":
        got = progressive.decode_progressive(got_h, use_native=False)
        want = jax_progressive.decode_progressive(want_h, use_native=False)
    else:
        got = entropy.decode_scan(got_h)
        want = jax_entropy.decode_scan(want_h)
    np.testing.assert_array_equal(got, want)
    if case != "progressive":
        np.testing.assert_array_equal(got, decode_scan_native(got_h))


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_rgb(blobs, case):
    got = oracle.decode_bytes_oracle(blobs[case])
    want = jax_oracle.decode_bytes_oracle(blobs[case])
    assert got.rgb.dtype == np.uint8
    np.testing.assert_array_equal(got.rgb, want.rgb)
    for scale in (2, 8):
        np.testing.assert_array_equal(
            oracle.decode_scaled_oracle(blobs[case], scale),
            jax_oracle.decode_scaled_oracle(blobs[case], scale))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bmp_bytes(blobs, case, tmp_path):
    rgb = jax_oracle.decode_bytes_oracle(blobs[case]).rgb
    data = bmp.encode_bmp(rgb)
    assert data == jax_bmp.encode_bmp(rgb)
    np.testing.assert_array_equal(bmp.read_bmp(data), rgb)
    bmp.write_bmp(str(tmp_path / "port.bmp"), rgb)
    jax_bmp.write_bmp(str(tmp_path / "jax.bmp"), rgb)
    assert ((tmp_path / "port.bmp").read_bytes()
            == (tmp_path / "jax.bmp").read_bytes())


def test_spec_and_idct_copies():
    assert {k: dataclasses.astuple(v) for k, v in specs.MODES.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_specs.MODES.items()}
    for n in (8, 4, 2, 1):
        assert specs.reduced_idct_matrix(n) == jax_specs.reduced_idct_matrix(n)
    names = [n for n in dir(jax_specs) if n.isupper() and n != "MODES"]
    assert [getattr(specs, n) for n in names] == [
        getattr(jax_specs, n) for n in names]
    rng = np.random.default_rng(3)
    x = [rng.integers(-32768, 32768, 500).astype(np.int32) for _ in range(8)]
    for shift in (11, 18):
        for a, b in zip(idct_math.idct_1d(x, shift),
                        jax_idct_math.idct_1d(x, shift)):
            np.testing.assert_array_equal(a, b)


def test_config_and_timers_copies(monkeypatch):
    monkeypatch.setenv("PIM_JPEG_TPU_BUDGET_MCUS", "2048")
    monkeypatch.setenv("PIM_JPEG_TPU_WIRE", "i16")
    assert (dataclasses.asdict(config.EngineConfig.from_env())
            == dataclasses.asdict(jax_config.EngineConfig.from_env()))
    assert profiling.STAGES == jax_profiling.STAGES
    timers = profiling.StageTimers()
    with timers.stage("prepare"):
        pass
    assert set(timers.snapshot()) == set(jax_profiling.StageTimers()
                                         .snapshot()) | {"prepare"}


def test_native_library_is_the_ports_own(monkeypatch, tmp_path):
    """The port builds its own entropy.cpp into a directory of its own, so
    the two packages never share a library; PIM_JPEG_TPU_CACHE moves both
    and still keeps them apart."""
    assert binding._SRC == os.path.join(PORT, "native", "entropy.cpp")
    assert binding._SRC != jax_binding._SRC
    assert os.path.basename(binding._cache_dir()) == "pim_jpeg_tpu_torch"
    assert binding._cache_dir() != jax_binding._cache_dir()
    lib = binding.load()
    assert lib is not None and lib is not jax_binding.load()
    assert os.path.dirname(lib._name) == binding._cache_dir()
    monkeypatch.setenv("PIM_JPEG_TPU_CACHE", str(tmp_path))
    assert binding._cache_dir() == str(tmp_path / "pim_jpeg_tpu_torch")
    assert jax_binding._cache_dir() == str(tmp_path)
