"""Synthetic spectra generators (reference layer L0, survey §1).

Faithful functional ports of the seven reference generator scripts —
``gensimple_horns.py``, ``gennothing.py``, ``gensimple.py``,
``gensimple_bright.py``, ``gensimple_faint.py``, ``gen.py``,
``gen_realistic.py`` — reproducing each script's exact ``numpy.random``
draw *sequence* (seed, distribution, size, order), so the output arrays are
bit-identical to running the reference script with the same N. Each returns
a dict of arrays matching the reference's HDF5 schema (``x``, ``y`` and
truth parameters), plus ``noise_level``.

Draw-order notes (load-bearing for exact equality):

- ``gensimple*.py`` add noise in a per-dataset loop
  (``for i in range(N): y[:,i] += normal(size=len(x))``,
  gensimple.py:55-57) — equivalent to one ``(N, nx)`` draw transposed;
  ``gen.py``/``gen_realistic.py``/``gennothing.py`` draw the full
  ``(nx, N)`` block at once (gen.py:50, gen_realistic.py:53).
- ``gen.py`` and ``gen_realistic.py`` seed with 1 (gen.py:19,
  gen_realistic.py:20); the others seed with N.
- ``gen_realistic.py`` always generates N=10000 datasets and truncates
  ``y`` to the requested count afterwards (gen_realistic.py:55-57); truth
  arrays stay full-length.

The port's own copy of ``massivedatans_tpu/datagen/generators.py``:
same seeds, same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np

NOISE_LEVEL = 0.01  # every reference generator hardcodes 0.01


def _gauss(x, A, mu, sig):
    """Batched Gaussian line (gensimple_horns.py:8-13): returns [nx, N]."""
    A = np.atleast_1d(A)[None, :]
    mu = np.atleast_1d(mu)[None, :]
    sig = np.atleast_1d(sig)[None, :]
    return A * np.exp(-0.5 * ((mu - x[:, None]) / sig) ** 2)


def _gauss_z(x, z, A, mu, sig):
    """Redshift-convention Gaussian (gensimple.py:8-14): the *data* axis is
    blueshifted, ``A exp(-((mu - x/(1+z))/sig)^2 / 2)``. Returns [nx, N]."""
    arg = (mu[None, :] - x[:, None] / (1.0 + z[None, :])) / sig[None, :]
    return A[None, :] * np.exp(-0.5 * arg**2)


def _columnwise_noise(rng, N, nx, noise_level):
    """The gensimple*-family per-dataset noise loop (gensimple.py:55-57):
    N sequential length-nx draws == one (N, nx) draw, transposed."""
    return rng.normal(0, noise_level, size=(N, nx)).T


def gen_horns(N: int, seed=None) -> dict:
    """Single narrow line, arctan-transformed-uniform redshift, powerlaw
    amplitudes (gensimple_horns.py:15-39)."""
    rng = np.random.RandomState(N if seed is None else seed)
    x = np.linspace(400, 800, 200)
    z = np.arctan(rng.uniform(-np.pi, np.pi, size=N)) * 0.1
    rest_wave = 656
    width_narrow = 5.0 * np.ones(N)
    mean_narrow = rest_wave * (1 + z)
    signal_level = 0.02 / rng.power(3, size=N)
    y = _gauss(x, signal_level, mean_narrow, width_narrow)
    y = y + _columnwise_noise(rng, N, len(x), NOISE_LEVEL)
    return dict(
        x=x, y=y, z=z, mean_narrow=mean_narrow, width_narrow=width_narrow,
        height_narrow=signal_level, noise_level=NOISE_LEVEL,
    )


def gen_nothing(N: int, seed=None) -> dict:
    """Pure noise for evidence calibration (gennothing.py:7-12)."""
    rng = np.random.RandomState(N if seed is None else seed)
    x = np.linspace(400, 800, 200)
    y = rng.normal(0, NOISE_LEVEL, size=(len(x), N))
    return dict(x=x, y=y, noise_level=NOISE_LEVEL)


# --- the two-component (narrow + broad at rest_wave=440) family ------------
# Common physics (gensimple.py:16-40): line at rest 440 nm, fixed km/s
# widths (4000 km/s broad, 400 km/s narrow -> nm via * 440/3e5), broad
# amplitude = 0.1 x narrow, signal evaluated at x/(1+z).

_REST_WAVE = 440.0
_WIDTH_BROAD_KMS = 4000.0
_WIDTH_NARROW_KMS = 400.0


def _two_component(N, z, signal_level, rng):
    x = np.linspace(400, 800, 200)
    width_broad = _WIDTH_BROAD_KMS * _REST_WAVE / 300000 * np.ones(N)
    width_narrow = _WIDTH_NARROW_KMS * _REST_WAVE / 300000 * np.ones(N)
    mean_broad = _REST_WAVE * np.ones(N)
    mean_narrow = _REST_WAVE * np.ones(N)
    height_broad = 10**-1 * signal_level
    height_narrow = signal_level
    ym = _gauss_z(x, z, height_broad, mean_broad, width_broad)
    ym += _gauss_z(x, z, height_narrow, mean_narrow, width_narrow)
    y = ym + _columnwise_noise(rng, N, len(x), NOISE_LEVEL)
    return dict(
        x=x, y=y, z=z,
        mean_broad=mean_broad, width_broad=width_broad,
        height_broad=height_broad,
        mean_narrow=mean_narrow, width_narrow=width_narrow,
        height_narrow=height_narrow, noise_level=NOISE_LEVEL,
    )


def gen_simple(N: int, seed=None) -> dict:
    """gensimple.py: Beta(2,7) redshifts; amplitudes from a truncated
    normal(0.5, 0.5) > 0.2 (gensimple.py:20-41)."""
    rng = np.random.RandomState(N if seed is None else seed)
    z = rng.beta(2.0, 7.0, size=N) * 1
    signal_level = rng.normal(0.5, 0.5, size=10 * N)
    signal_level = signal_level[signal_level > 0.2][:N]
    return _two_component(N, z, signal_level, rng)


def gen_simple_bright(N: int, seed=None) -> dict:
    """gensimple_bright.py: fixed z=0.01, fixed amplitude 0.2 (SNR 20)
    (gensimple_bright.py:21-34)."""
    rng = np.random.RandomState(N if seed is None else seed)
    z = np.zeros(N) + 0.01
    signal_level = np.ones(N) * 0.2
    return _two_component(N, z, signal_level, rng)


def gen_simple_faint(N: int, seed=None) -> dict:
    """gensimple_faint.py: Beta(2,7) redshifts; amplitudes from a truncated
    normal(0.2, 0.2) > 0.1 (gensimple_faint.py:21-37)."""
    rng = np.random.RandomState(N if seed is None else seed)
    z = rng.beta(2.0, 7.0, size=N) * 1
    signal_level = rng.normal(0.2, 0.2, size=10 * N)
    signal_level = signal_level[signal_level > 0.1][:N]
    return _two_component(N, z, signal_level, rng)


def gen_agn(N: int, seed=None) -> dict:
    """gen.py: lognormal km/s widths, exponential amplitudes, 50/50
    type-1/type-2 broad-line mix; seed is ALWAYS 1 in the reference
    (gen.py:17-44)."""
    rng = np.random.RandomState(1 if seed is None else seed)
    x = np.linspace(400, 800, 200)
    z = rng.beta(2, 30, size=N) * 2
    rest_wave = 440
    width_broad = 10 ** rng.normal(3, 0.2, size=N) * rest_wave / 300000
    width_narrow = 10 ** rng.normal(1, 0.2, size=N) * rest_wave / 300000
    mean_broad = rest_wave * np.ones(N)
    mean_narrow = rest_wave * np.ones(N)
    signal_level = rng.exponential(size=N) * 10
    is_type1 = rng.uniform(size=N) < 0.5
    # both normal draws are consumed regardless of the branch (gen.py:37)
    h1 = 10 ** rng.normal(0, 0.2, size=N)
    h2 = 10 ** rng.normal(-2, 0.2, size=N)
    height_broad = np.where(is_type1, h1, h2) * signal_level
    height_narrow = signal_level
    ym = _gauss_z(x, z, height_broad, mean_broad, width_broad)
    ym += _gauss_z(x, z, height_narrow, mean_narrow, width_narrow)
    y = rng.normal(0, NOISE_LEVEL, size=ym.shape) + ym  # gen.py:50
    return dict(
        x=x, y=y, z=z, is_type1=is_type1,
        mean_broad=mean_broad, width_broad=width_broad,
        height_broad=height_broad,
        mean_narrow=mean_narrow, width_narrow=width_narrow,
        height_narrow=height_narrow, noise_level=NOISE_LEVEL,
    )


def gen_realistic(N: int, seed=None) -> dict:
    """gen_realistic.py: 1000-pixel grid; ALWAYS generates 10000 datasets
    with seed 1, then truncates y to the first N (gen_realistic.py:18-57).
    Amplitudes from the 'bright' inverse-power law 1/(100 U + 2)."""
    rng = np.random.RandomState(1 if seed is None else seed)
    x = np.linspace(400, 800, 1000)
    NFULL = 10000
    z = rng.beta(2, 30, size=NFULL) * 2
    rest_wave = 440
    width_broad = 10 ** rng.normal(3, 0.2, size=NFULL) * rest_wave / 300000
    width_narrow = 10 ** rng.normal(1, 0.2, size=NFULL) * rest_wave / 300000
    mean_broad = rest_wave * np.ones(NFULL)
    mean_narrow = rest_wave * np.ones(NFULL)
    signal_level = 1.0 / (rng.power(1, size=NFULL) * 100 + 2)  # "bright"
    is_type1 = rng.uniform(size=NFULL) < 0.5
    h1 = 10 ** rng.normal(0, 0.2, size=NFULL)
    h2 = 10 ** rng.normal(-2, 0.2, size=NFULL)
    height_broad = np.where(is_type1, h1, h2) * signal_level
    height_narrow = signal_level
    ym = _gauss_z(x, z, height_broad, mean_broad, width_broad)
    ym += _gauss_z(x, z, height_narrow, mean_narrow, width_narrow)
    y = rng.normal(0, NOISE_LEVEL, size=ym.shape) + ym  # gen_realistic.py:53
    y = y[:, :N]
    return dict(
        x=x, y=y, z=z, is_type1=is_type1,
        mean_broad=mean_broad, width_broad=width_broad,
        height_broad=height_broad,
        mean_narrow=mean_narrow, width_narrow=width_narrow,
        height_narrow=height_narrow, noise_level=NOISE_LEVEL,
    )


GENERATORS = {
    "horns": gen_horns,
    "nothing": gen_nothing,
    "simple": gen_simple,
    "bright": gen_simple_bright,
    "faint": gen_simple_faint,
    "agn": gen_agn,
    "realistic": gen_realistic,
}

# reference output filename stems (gensimple_horns.py:61, gennothing.py:14,
# gensimple.py:64, gensimple_bright.py:62, gensimple_faint.py:70, gen.py:59,
# gen_realistic.py:63)
FILENAME_STEMS = {
    "horns": "data_widths_{N}.hdf5",
    "nothing": "data_nothing_{N}.hdf5",
    "simple": "data_{N}.hdf5",
    "bright": "data_bright_{N}.hdf5",
    "faint": "data_faint_{N}.hdf5",
    "agn": "data.hdf5",
    "realistic": "data_realistic_{N}.hdf5",
}


def save_dataset(data: dict, path: str):
    import h5py

    with h5py.File(path, "w") as f:
        for k, v in data.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                f.create_dataset(k, data=arr)
            else:
                f.create_dataset(k, data=arr, compression="gzip", shuffle=True)
