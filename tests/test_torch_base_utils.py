"""The port's numpy utilities against the JAX package's, on the same inputs:
the grid spacings, the flux-correction weights (their properties and their
validation errors), the preferences parser (a file and the bad line), the
mountain-wave eigensolver (eigenpairs) and its two topography generators,
mirroring ``tests/test_base_utils.py`` case by case; the post-processing
tools on ``.npz`` and ``.nc`` files that the port's ``ReferenceOutput``
writes, against the JAX functions on the same files; and ``devprof`` on
the CPU."""

import numpy as np
import pytest
import torch

import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.ops import spacing as j_sp
from tempestmodel_tpu.ops import flux_correction as j_fc
from tempestmodel_tpu.utils import mountain_waves as j_mw
from tempestmodel_tpu.utils import postprocess as j_pp
from tempestmodel_tpu.utils import preferences as j_pref
from tempestmodel_tpu.io import netcdf as j_nc
from tempestmodel_tpu_torch.ops import spacing as t_sp
from tempestmodel_tpu_torch.ops import flux_correction as t_fc
from tempestmodel_tpu_torch.ops import column_ops as t_co
from tempestmodel_tpu_torch.utils import mountain_waves as t_mw
from tempestmodel_tpu_torch.utils import postprocess as t_pp
from tempestmodel_tpu_torch.utils import preferences as t_pref
from tempestmodel_tpu_torch.utils import devprof

from torch_port_common import CPU, torch_config, TorchUMJS


def _same(got, want):
    """Equal as nested tuples of arrays (bit for bit: the port runs the
    same numpy code)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- spacing

SPACING = [("uniform_nodes", (4, 0.5, 1.0)), ("uniform_edges", (4, 0.5, 1.0)),
           ("uniform_norm_areas", (4, 0.5)), ("gll_nodes", (3, 4, 1.0)),
           ("gll_nodes", (5, 6, 0.25, -1.0)), ("gll_norm_areas", (3, 4, 1.0)),
           ("gll_repeated_nodes", (3, 4, 1.0)),
           ("gll_repeated_norm_areas", (3, 4, 1.0)),
           ("mixed_gll_gauss_nodes", (3, 4, 1.0)),
           ("mixed_gll_gauss_norm_areas", (3, 4, 1.0)),
           ("mixed_gll_gauss_nodes", (2, 5, 2.0, 3.0))]


@pytest.mark.parametrize("fn,args", SPACING,
                         ids=[f"{f}{a}" for f, a in SPACING])
def test_spacing_matches_jax(fn, args):
    got = getattr(t_sp, fn)(*args)
    _same(got, getattr(j_sp, fn)(*args))


def test_spacing_properties():
    """tests/test_base_utils.py's checks on the port's spacings."""
    assert np.allclose(t_sp.uniform_nodes(4, 0.5, 1.0),
                       [1.25, 1.75, 2.25, 2.75])
    nodes, areas = t_sp.gll_nodes(3, 4, 1.0), t_sp.gll_norm_areas(3, 4, 1.0)
    assert len(nodes) == 10 and np.all(np.diff(nodes) > 0)
    assert abs(areas.sum() - 3.0) < 1e-13
    assert np.allclose(nodes[[0, 3, 6, 9]], [0.0, 1.0, 2.0, 3.0])
    rep = t_sp.gll_repeated_nodes(3, 4, 1.0)
    assert len(rep) == 12 and abs(rep[3] - rep[4]) < 1e-14
    nodes, edges = t_sp.mixed_gll_gauss_nodes(3, 4, 1.0)
    na, ea = t_sp.mixed_gll_gauss_norm_areas(3, 4, 1.0)
    assert np.all(nodes > edges[:-1]) and np.all(nodes < edges[1:])
    assert abs(na.sum() - 3.0) < 1e-13 and abs(ea.sum() - 3.0) < 1e-13


@pytest.mark.parametrize("fn", ["gll_nodes", "gll_repeated_nodes",
                                "mixed_gll_gauss_nodes"])
def test_spacing_refuses_order_one(fn):
    for mod in (t_sp, j_sp):
        with pytest.raises(ValueError):
            getattr(mod, fn)(3, 1, 1.0)


# ------------------------------------------------------- flux correction

@pytest.mark.parametrize("itype,order", [(1, 3), (2, 3), (2, 4), (3, 4),
                                         (1, 1), (2, 6)])
def test_flux_correction_matches_jax(itype, order):
    """The weights equal JAX's, g(1) - g(0) = 1 (the integral of g' over
    [0, 1]), and the column operators' own copy agrees."""
    xs, ws = np.polynomial.legendre.leggauss(24)
    x, w = 0.5 * (xs + 1.0), 0.5 * ws
    got = t_fc.flux_correction_derivatives(itype, order, x)
    np.testing.assert_array_equal(
        got, j_fc.flux_correction_derivatives(itype, order, x))
    assert np.isfinite(got).all()
    if order > itype:
        assert abs((got * w).sum() - 1.0) < 1e-10
    np.testing.assert_allclose(
        t_co.flux_correction_derivatives(itype, order, x), got, rtol=0,
        atol=1e-12 * np.abs(got).max())


@pytest.mark.parametrize("itype,order", [(0, 4), (2, 0), (-1, 3)])
def test_flux_correction_validation(itype, order):
    for fn in (t_fc.flux_correction_derivatives,
               j_fc.flux_correction_derivatives):
        with pytest.raises(ValueError):
            fn(itype, order, [0.5])


# ----------------------------------------------------------- preferences

PREFS = """
# comment
resolution = 30
dt = 200.0            # trailing comment
scheme = KGU35
verbose = true
hex = 0x10
quiet = off
"""


@pytest.mark.parametrize("what", ["file", "dict"])
def test_preferences_parse_matches_jax(tmp_path, what):
    f = tmp_path / "prefs.txt"
    f.write_text(PREFS)
    src = str(f) if what == "file" else {"resolution": 30, "dt": 200.0,
                                         "scheme": "KGU35", "verbose": True,
                                         "hex": "0x10", "quiet": "off"}
    p, q = t_pref.Preferences(src), j_pref.Preferences(src)
    assert dict(p.items()) == dict(q.items())
    assert p.get_int("resolution") == q.get_int("resolution") == 30
    assert p.get_int("hex") == 16
    assert p.get_double("dt") == 200.0
    assert p.get_string("scheme") == "KGU35"
    assert p.get_string_nocase("scheme") == "kgu35"
    assert p.get_bool("verbose") is True and p.get_bool("quiet") is False
    assert "resolution" in p and len(p) == len(q) == 6
    assert p.get("missing", default=7, cast=int) == 7
    assert p.get("dt", cast=float) == 200.0
    with pytest.raises(KeyError):
        p.get_string("missing")
    with pytest.raises(ValueError):
        p.get_bool("scheme")


@pytest.mark.parametrize("text", ["this is not a pair\n",
                                  "a = 1\n\nno equals sign here # x\n"])
def test_preferences_bad_line(tmp_path, text):
    f = tmp_path / "bad.txt"
    f.write_text(text)
    msgs = []
    for cls in (t_pref.Preferences, j_pref.Preferences):
        with pytest.raises(ValueError) as e:
            cls(str(f))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------- mountain waves

@pytest.mark.parametrize("k,nphi", [(8, 16), (3, 10)])
def test_evolution_matrix_matches_jax(k, nphi):
    p = t_mw.WaveParameters(n_phi_elements=nphi)
    q = j_mw.WaveParameters(n_phi_elements=nphi)
    got, want = t_mw.generate_evolution_matrix(k, p), \
        j_mw.generate_evolution_matrix(k, q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (5 * nphi - 1,) * 2
    _same(p.latitude_arrays(), q.latitude_arrays())


@pytest.mark.parametrize("k,nphi", [(8, 16), (3, 10)])
def test_wave_modes_eigenpairs(k, nphi):
    """Every returned pair satisfies the transposed pencil, and the finite
    eigenvalues are JAX's (eigenvectors only up to a scale)."""
    p = t_mw.WaveParameters(n_phi_elements=nphi)
    M, B, _, _ = t_mw.generate_evolution_matrix(k, p)
    lamf, vrf = t_mw.finite_modes(*t_mw.wave_modes(k, p))
    jlam, _ = j_mw.finite_modes(*j_mw.wave_modes(
        k, j_mw.WaveParameters(n_phi_elements=nphi)))
    assert len(lamf) > 0 and len(lamf) == len(jlam)
    np.testing.assert_allclose(np.sort_complex(lamf), np.sort_complex(jlam),
                               rtol=1e-10, atol=1e-10)
    for i in range(min(5, len(lamf))):
        r = M.T @ vrf[:, i] - lamf[i] * (B.T @ vrf[:, i])
        assert np.abs(r).max() < 1e-10 * max(1.0, abs(lamf[i]))


@pytest.mark.parametrize("fn,kw", [
    ("schar_topography", {}),
    ("schar_topography", {"h0": 100.0, "d": 2e4, "xi": 8e3, "lat_c": 0.3}),
    ("wave_topography", {}),
    ("wave_topography", {"k": 3, "lat_width": 0.5, "lat_c": -0.2})])
def test_topography_generators_match_jax(fn, kw):
    rng = np.random.default_rng(3)
    lon = rng.uniform(0.0, 2.0 * np.pi, 200)
    lat = rng.uniform(-0.5 * np.pi, 0.5 * np.pi, 200)
    np.testing.assert_array_equal(getattr(t_mw, fn)(lon, lat, **kw),
                                  getattr(j_mw, fn)(lon, lat, **kw))


def test_topography_generators():
    h = t_mw.schar_topography(np.array([np.pi / 4.0]), np.array([0.0]))
    assert abs(h[0] - 250.0) < 1e-10
    far = t_mw.schar_topography(np.array([np.pi / 4.0 + 0.1]),
                                np.array([0.0]))
    assert far[0] < 1e-6
    lon = np.linspace(0, 2 * np.pi, 33)[:-1]
    h = t_mw.wave_topography(lon, np.zeros_like(lon), k=8)
    assert np.argmax(np.abs(np.fft.rfft(h))) == 8


# ----------------------------------------------------------- postprocess

@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Lat-lon files of the port's ``ReferenceOutput`` from a UMJS model at
    ne2 nz6 on the CPU: three outputs in each format (steps 0, 1, 2), the
    same fields in both."""
    from tempestmodel_tpu_torch import model as t_model
    from tempestmodel_tpu_torch.io import output as t_output
    root = tmp_path_factory.mktemp("post")
    cfg = torch_config(ne=2, nz=6, dt=300.0,
                       equation_set=tt.EquationSet.PRIMITIVE_NONHYDRO)
    oms = [t_output.ReferenceOutput(300.0, str(root / fmt), nlat=9,
                                    nlon=16, fmt=fmt,
                                    output_surface_pressure=True,
                                    output_vorticity=True)
           for fmt in ("npz", "nc")]
    m = t_model.Model(cfg, TorchUMJS(pert="exp"), output_managers=oms,
                      device=CPU)
    m.go(nsteps=2)
    return {fmt: sorted(str(p) for p in (root / fmt).iterdir())
            for fmt in ("npz", "nc")}


def test_load_output_matches_jax_on_npz(outputs):
    for path in outputs["npz"]:
        got, want = t_pp.load_output(path), j_pp.load_output(path)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_load_output_reads_netcdf_in_the_npz_layout(outputs):
    """A ``.nc`` file comes back with the ``.npz`` file's keys, shapes and
    values (the file stores float64; lat / lon went through degrees), and
    its raw variables are what the JAX reader sees."""
    assert len(outputs["nc"]) == len(outputs["npz"]) == 3
    for nc, npz in zip(outputs["nc"], outputs["npz"]):
        got, want = t_pp.load_output(nc), j_pp.load_output(npz)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k], np.float64)
            assert np.shape(got[k]) == w.shape, k
            np.testing.assert_allclose(got[k], w, rtol=1e-15,
                                       atol=1e-15 * np.abs(w).max(),
                                       err_msg=k)
        raw = j_nc.read_netcdf(nc)
        assert raw["U"].shape == (1, 6, 9, 16) and raw["W"].shape[1] == 7
        assert raw["PS"].shape == (1, 9, 16)


@pytest.mark.parametrize("fmt", ["npz", "nc"])
@pytest.mark.parametrize("level", [0, 3, -1])
def test_extract_surface_matches_jax(outputs, fmt, level):
    for path, npz in zip(outputs[fmt], outputs["npz"]):
        data = t_pp.load_output(path)
        got = t_pp.extract_surface(data, level)
        want = j_pp.extract_surface(j_pp.load_output(npz), level)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-15,
                                       atol=1e-15 * np.abs(want[k]).max())
        # JAX's function on the port's NetCDF data: the same result
        jgot = j_pp.extract_surface(data, level)
        for k in got:
            np.testing.assert_array_equal(jgot[k], got[k])
        assert got["T"].shape == (9, 16) and got["PS"].shape == (9, 16)


@pytest.mark.parametrize("fmt", ["npz", "nc"])
def test_zonal_temporal_average_matches_jax(outputs, fmt):
    got = t_pp.zonal_temporal_average(outputs[fmt])
    want = j_pp.zonal_temporal_average(outputs["npz"])
    assert set(got) == set(want) and got["nfiles"] == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-14,
                                   atol=1e-14 * np.abs(want[k]).max())
    assert got["U"].shape == (9, 6)
    with pytest.raises(ValueError):
        t_pp.zonal_temporal_average([])


@pytest.mark.parametrize("cmd", ["extract_surface", "zonal_temporal_average",
                                 "cfconvert"])
def test_postprocess_main_matches_jax(outputs, tmp_path, cmd):
    src = outputs["npz"][1]
    argv = {"extract_surface": [src, "--level", "2"],
            "zonal_temporal_average": [str(outputs["npz"][0])[:-10] + "*"],
            "cfconvert": [src]}[cmd]
    outs = []
    for name, mod in (("t", t_pp), ("j", j_pp)):
        out = str(tmp_path / f"{name}.npz")
        args = [cmd] + argv[:1] + [out] + argv[1:]
        assert mod.main(args) == 0
        outs.append(np.load(out))
    assert set(outs[0].files) == set(outs[1].files)
    for k in outs[1].files:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_to_cf_dataset_needs_xarray(outputs):
    try:
        import xarray  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            t_pp.to_cf_dataset(t_pp.load_output(outputs["npz"][0]))
    else:
        ds = t_pp.to_cf_dataset(t_pp.load_output(outputs["npz"][0]))
        assert ds.attrs["source"] == "tempestmodel_tpu_torch"


# --------------------------------------------------------------- devprof

def test_device_time_on_the_cpu_counts_no_kernel():
    """Without a CUDA device the profiler's trace has no device events: no
    time and no kernel, after the warm-up call and the traced one."""
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": (x @ x).sum()}

    ms, n = devprof.device_time_ms(fn, torch.ones(32, 32))
    assert len(calls) == 2
    if not torch.cuda.is_available():
        assert (ms, n) == (0.0, 0)

