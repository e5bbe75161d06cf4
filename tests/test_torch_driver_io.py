"""The port's host utilities and I/O against the JAX package's, float64 on
the CPU, with no JAX step compiled: duration parsing and model time,
the timers' and the announcements' text, the checksum, error-norm and
conservation diagnostics on a seeded UMJS state (ne2 p4 nz6, 1e-13
relative), vorticity and divergence, the lat-lon interpolation tables
(equal) and their output (1e-13), NetCDF files across the two packages,
and the arena packer's bytes."""

import io

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tempestmodel_tpu as tj
from tempestmodel_tpu.io import arena as j_arena
from tempestmodel_tpu.io import diagnostics as j_diag
from tempestmodel_tpu.io import latlon as j_latlon
from tempestmodel_tpu.io import netcdf as j_netcdf
from tempestmodel_tpu.models import hyperdiff as j_hyperdiff
from tempestmodel_tpu.utils import announce as j_announce
from tempestmodel_tpu.utils import timeobj as j_timeobj
from tempestmodel_tpu.utils import timers as j_timers
from tempestmodel_tpu_torch._device import OnDevice
from tempestmodel_tpu_torch.io import arena as t_arena
from tempestmodel_tpu_torch.io import diagnostics as t_diag
from tempestmodel_tpu_torch.io import latlon as t_latlon
from tempestmodel_tpu_torch.io import netcdf as t_netcdf
from tempestmodel_tpu_torch.models import hyperdiff as t_hyperdiff
from tempestmodel_tpu_torch.utils import announce as t_announce
from tempestmodel_tpu_torch.utils import timeobj as t_timeobj
from tempestmodel_tpu_torch.utils import timers as t_timers

from torch_port_common import CPU, FIELDS, JaxUMJS, build_pair, rel_err

DURATIONS = ["200s", "30d", "1.5h", "10m", "  7 ", "1e3s", "-2.5h", "0.5D",
             ".25H", "+3", "45", 12, 3.5]
BAD_DURATIONS = ["abc", "5x", "1.2.3s", ""]


@pytest.mark.parametrize("text", DURATIONS)
def test_durations_parse_as_in_jax(text):
    got = t_timeobj.parse_duration_seconds(text)
    assert got == j_timeobj.parse_duration_seconds(text)
    assert isinstance(got, float)


@pytest.mark.parametrize("text", BAD_DURATIONS)
def test_bad_durations_raise_as_in_jax(text):
    with pytest.raises(ValueError):
        j_timeobj.parse_duration_seconds(text)
    with pytest.raises(ValueError):
        t_timeobj.parse_duration_seconds(text)


def test_model_time_matches_jax():
    for cal in ("none", "noleap"):
        jt = j_timeobj.Time.from_seconds(
            123456789.25, j_timeobj.Calendar(cal))
        tt_ = t_timeobj.Time.from_seconds(
            123456789.25, t_timeobj.Calendar(cal))
        assert tt_.pretty() == jt.pretty()
        assert tt_.add_seconds(86400.0 * 40).pretty() \
            == jt.add_seconds(86400.0 * 40).pretty()
        assert tt_.as_seconds() == jt.as_seconds()
    assert (t_timeobj.Time(year=1, month=3, day=2,
                           calendar=t_timeobj.Calendar.NO_LEAP)
            - t_timeobj.Time(calendar=t_timeobj.Calendar.NO_LEAP)) \
        == (j_timeobj.Time(year=1, month=3, day=2,
                           calendar=j_timeobj.Calendar.NO_LEAP)
            - j_timeobj.Time(calendar=j_timeobj.Calendar.NO_LEAP))


def test_model_config_takes_duration_strings():
    import tempestmodel_tpu_torch as tt
    cfg = tt.ModelConfig()
    assert cfg.with_(dt="300s").dt == 300.0
    assert cfg.with_(dt="1.5h").dt == tj.ModelConfig().with_(dt="1.5h").dt
    assert cfg.with_(dt=20).dt == 20.0


def test_timer_report_text_matches_jax():
    jt_, tt_ = j_timers.Timers(sync=False), t_timers.Timers(sync=False)
    for name, dts in (("Loop", [1.25]), ("Step", [0.001, 0.003, 0.002]),
                      ("Output", [0.5e-3])):
        for dt in dts:
            jt_.groups[name].add(dt)
            tt_.groups[name].add(dt)
    jout, tout = [], []
    jt_.report(printer=jout.append)
    tt_.report(printer=tout.append)
    assert tout == jout and len(tout) == 4
    assert tt_.as_dict() == jt_.as_dict()


def test_a_timer_scope_can_stand_for_several_entries():
    timers = t_timers.Timers(device="cpu")
    with timers.time("Step", count=4):
        pass
    with timers.time("Step"):
        pass
    g = timers.groups["Step"]
    assert g.count == 5 and g.min <= g.max


def _announce_calls(an):
    an.announce_banner("TEST")
    an.announce("top")
    with an.block("Block A"):
        an.announce("inside")
        an.announce(2, "hidden detail")
        with an.block("Nested", done="Finished"):
            an.announce("deep")
        an.announce_start_block("manual")
        an.announce_end_block()
    an.announce_banner()
    an.announce_set_verbosity(2)
    an.announce(2, "now visible")
    an.announce_set_verbosity(1)


def test_announce_text_matches_jax():
    texts = []
    for an in (j_announce, t_announce):
        buf = io.StringIO()
        an.announce_set_output(buf)
        an.announce_set_verbosity(1)
        an.announce_only_rank_zero(True)
        try:
            _announce_calls(an)
        finally:
            an.announce_set_output(None)
            an.announce_only_rank_zero(False)
        texts.append(buf.getvalue())
    assert texts[1] == texts[0]
    assert "..inside" in texts[1] and "hidden detail" not in texts[1]


@pytest.fixture(scope="module")
def umjs():
    """(jgeom, tgeom, tcfg, state, reference) at ne2 p4 nz6: the UMJS start
    with seeded noise on every field and two seeded tracer species (numpy,
    z-last), and the reference state."""
    jcfg, jgeom, tcfg, tgeom = build_pair(ne=2, nz=6)
    js = JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants)
    ref = JaxUMJS(pert="exp").reference_state(jgeom, jcfg.constants)
    rng = np.random.default_rng(7)
    state = {}
    for k in FIELDS:
        v = np.asarray(js[k])
        scale = np.abs(v).max() if k != "W" else 0.05
        state[k] = v + 1e-3 * scale * rng.standard_normal(v.shape)
    state["Tracers"] = np.abs(rng.standard_normal((2,) + state["U"].shape))
    return (jgeom, tgeom, tcfg, state,
            {k: np.asarray(v) for k, v in ref.items()})


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


@pytest.mark.parametrize("kind", ["sum", "l1", "l2", "linf"])
def test_checksums_match_jax(umjs, kind):
    jgeom, tgeom, _, state, _ = umjs
    want = j_diag.state_checksums(_j(state), jgeom.area3d, kind,
                                  jgeom.area3d_int)
    got = t_diag.state_checksums(_t(state), tgeom.area3d, kind,
                                 tgeom.area3d_int)
    # a signed sum is held against the sum of magnitudes (its terms'
    # scale), every other kind against itself
    scale = j_diag.state_checksums(_j(state), jgeom.area3d, "l1",
                                   jgeom.area3d_int) if kind == "sum" \
        else want
    assert list(got) == list(want)
    assert set(got) == set(FIELDS) | {"Q0", "Q1"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) \
            <= 1e-13 * abs(float(scale[k])), (k, got[k], want[k])


def test_error_norms_match_jax(umjs):
    jgeom, tgeom, _, state, ref = umjs
    want = j_diag.error_norms(_j(state), _j(ref), jgeom.area3d,
                              jgeom.area3d_int)
    # the device view of the geometry gives the same numbers
    for geom_area in (tgeom, OnDevice(tgeom, CPU)):
        got = t_diag.error_norms(_t(state), _t(ref), geom_area.area3d,
                                 geom_area.area3d_int)
        assert set(got) == set(want)
        for k in want:
            for norm, w in want[k].items():
                g = float(got[k][norm])
                assert abs(g - float(w)) <= 1e-13 * abs(float(w)), (k, norm)


def test_conservation_integrals_match_jax(umjs):
    jgeom, tgeom, tcfg, state, _ = umjs
    c = tcfg.constants
    jc = tj.ModelConfig().constants
    for geom in (tgeom, OnDevice(tgeom, CPU)):
        pairs = (
            (t_diag.nh_total_energy(_t(state), geom, c),
             j_diag.nh_total_energy(_j(state), jgeom, jc)),
            (t_diag.nh_zonal_momentum(_t(state), geom),
             j_diag.nh_zonal_momentum(_j(state), jgeom)),
            (t_diag.nh_vertical_momentum(_t(state), geom),
             j_diag.nh_vertical_momentum(_j(state), jgeom)))
        for got, want in pairs:
            assert isinstance(got, float)
            assert abs(got - want) <= 1e-13 * abs(want), (got, want)


def test_curl_and_div_match_jax(umjs):
    jgeom, tgeom, _, state, _ = umjs
    want = j_hyperdiff.curl_and_div(jnp.asarray(state["U"]),
                                    jnp.asarray(state["V"]), jgeom)
    got = t_hyperdiff.curl_and_div(torch.from_numpy(state["U"]),
                                   torch.from_numpy(state["V"]),
                                   OnDevice(tgeom, CPU))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < 1e-13


def test_latlon_tables_and_output_match_jax(umjs):
    jgeom, tgeom, tcfg, state, _ = umjs
    jit = j_latlon.build_latlon_interp(jgeom, 19, 36)
    tit = t_latlon.build_latlon_interp(tgeom, 19, 36, device=CPU)
    for name in ("lat", "lon"):
        np.testing.assert_array_equal(getattr(tit, name), getattr(jit, name))
    for name in ("panel", "ia", "ib", "ca", "cb", "vec_t"):
        np.testing.assert_array_equal(getattr(tit, name).numpy(),
                                      np.asarray(getattr(jit, name)))
    assert tit.shape == (19, 36)
    got = tit.scalar(torch.from_numpy(state["Rt"]))
    assert got.shape == (19, 36, 6)
    assert rel_err(got.numpy(), jit.scalar(jnp.asarray(state["Rt"]))) < 1e-13
    a = tcfg.constants.earth_radius
    gu, gv = tit.vector(torch.from_numpy(state["U"]),
                        torch.from_numpy(state["V"]), a)
    wu, wv = jit.vector(jnp.asarray(state["U"]), jnp.asarray(state["V"]), a)
    assert rel_err(gu.numpy(), wu) < 1e-13 and rel_err(gv.numpy(), wv) < 1e-13
    # a float32 field comes out in the wider dtype of the tables
    f32 = tit.scalar(torch.from_numpy(state["Rho"]).float())
    assert f32.dtype == torch.float64
    assert rel_err(f32.numpy(), jit.scalar(jnp.asarray(
        state["Rho"].astype(np.float32)))) < 1e-13


def test_netcdf_files_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(3)
    fields = {"U": rng.standard_normal((5, 8, 4)),
              "W": rng.standard_normal((5, 8, 5)),
              "PS": rng.standard_normal((5, 8)),
              "Q0": rng.standard_normal((5, 8, 4))}
    lat = np.linspace(-80.0, 80.0, 5)
    lon = np.linspace(0.0, 315.0, 8)
    lev = np.array([100.0, 300.0, 600.0, 1000.0])
    for writer, reader, name in (
            (t_netcdf.write_netcdf, j_netcdf.read_netcdf, "port.nc"),
            (j_netcdf.write_netcdf, t_netcdf.read_netcdf, "jax.nc")):
        path = str(tmp_path / name)
        writer(path, fields, lat, lon, lev=lev, time=600.0)
        got = reader(path)
        np.testing.assert_array_equal(got["lat"], lat)
        np.testing.assert_array_equal(got["lev"], lev)
        np.testing.assert_array_equal(got["time"], [600.0])
        np.testing.assert_array_equal(got["U"][0], np.moveaxis(
            fields["U"], 2, 0))
        np.testing.assert_array_equal(got["W"][0], np.moveaxis(
            fields["W"], 2, 0))
        np.testing.assert_array_equal(got["PS"][0], fields["PS"])
        assert got["lev1"].shape == (5,)
        with open(path, "rb") as fh:
            assert fh.read(3) == b"CDF"


def test_arena_bytes_match_jax_and_corruption_raises():
    if not (t_arena.available() and j_arena.available()):
        pytest.skip("no C++ toolchain: the arena library cannot be built")
    rng = np.random.default_rng(5)
    d = {"state_U": rng.standard_normal((6, 8, 8, 6)),
         "state_W": rng.standard_normal((6, 8, 8, 7)).astype(np.float32),
         "carry_Rt": rng.standard_normal((6, 6, 8, 8)),
         "step": np.int64(3).reshape(()),
         "time": np.float64(600.0).reshape(()),
         "idx": np.arange(11, dtype=np.int32)}
    buf = t_arena.pack(d)
    assert buf == j_arena.pack(d)
    out = t_arena.unpack(buf)
    assert list(out) == list(d)
    for k in d:
        np.testing.assert_array_equal(out[k], d[k])
        assert out[k].dtype == np.asarray(d[k]).dtype
    bad = bytearray(buf)
    bad[len(buf) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        t_arena.unpack(bytes(bad))
    with pytest.raises(ValueError):
        t_arena.unpack(b"\0" * 64)
