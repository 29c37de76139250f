"""The port's tile table (``repro_torch/kernels/katana_bank/autotune.py``)
against the JAX package's (``repro/kernels/katana_bank/autotune.py``):
the same lookup on the same file (exact key, nearest N in log space,
the first row for N None or <= 0, {} for a missing or broken table, an
unknown kernel or another format), files written by either package read
by the other, the checked-in table of the card well formed; the ops
wrappers' ``lane_tile=0`` / ``time_chunk=0`` resolved through the table
under ``cpu/plain`` (``ops.LAST_CONFIG``), an explicit tile winning, a
tile that is not instantiated refused; a tabled time chunk giving the
one-chunk bits, and the reference's ops (interpret mode, its own tuned
defaults) within the port-vs-reference bank tests' 1e-5; the tuner
(``tune.py``) with an injected measure."""
import json

import numpy as np
import pytest
import torch

from repro.execmode import ExecMode
from repro.kernels.katana_bank import autotune as jtab
from repro.kernels.katana_bank import ops as jops
from repro_torch.kernels.katana_bank import autotune as ttab
from repro_torch.kernels.katana_bank import ops as tops
from repro_torch.kernels.katana_bank import tune

from _torch_inputs import replay_inputs
from _torch_parity import models, np_

CARD = "cuda/NVIDIA H100 80GB HBM3"
MODES = {"cpu/interpret": ExecMode("auto", "interpret", "cpu", False, None,
                                   "x"),
         "tpu/compiled": ExecMode("auto", "compiled", "tpu", True, None, "x"),
         CARD: ExecMode("auto", CARD.split("/")[1], "cuda", True, None, "x")}
ENTRIES = {
    "katana_bank_sequence": {
        "cpu/interpret": [
            dict(N=64, lane_tile=128, time_chunk=1024, us_per_frame=1.0),
            dict(N=1024, lane_tile=512, time_chunk=4096, us_per_frame=2.0)],
        CARD: [dict(N=8192, lane_tile=256, time_chunk=150,
                    us_per_frame=3.0)],
    },
    "katana_bank": {
        "cpu/interpret": [dict(N=64, lane_tile=64, us_per_frame=1.0)],
        "tpu/compiled": [dict(N=256, lane_tile=256, us_per_frame=0.5),
                         dict(N=4096, lane_tile=512, us_per_frame=0.7)],
        CARD: [dict(N=1024, lane_tile=64, us_per_frame=9.0),
               dict(N=131072, lane_tile=256, us_per_frame=8.0)],
    },
}
# (kernel, N, key): the reference's own cases (tests/test_autotune.py:
# N=100 -> the 64 row, N=500 -> the 1,024 row, the key exact, an unknown
# kernel) and more
CASES = [("katana_bank_sequence", 100, "cpu/interpret"),
         ("katana_bank_sequence", 500, "cpu/interpret"),
         ("katana_bank_sequence", 64, "tpu/compiled"),
         ("nope", 64, "cpu/interpret"),
         ("katana_bank_sequence", None, "cpu/interpret"),
         ("katana_bank_sequence", 0, "cpu/interpret"),
         ("katana_bank_sequence", 1, "cpu/interpret"),
         ("katana_bank_sequence", 10 ** 6, CARD),
         ("katana_bank", 1, "tpu/compiled"),
         ("katana_bank", 1100, "tpu/compiled"),
         ("katana_bank", 5000, CARD),
         ("katana_bank", 20000, CARD),
         ("katana_bank", 64, "cpu/interpret"),
         ("katana_bank", 64, CARD.replace("H100", "A100"))]
WANT_TILE = [128, 512, None, None, 128, 128, 128, 256, 256, 512, 64, 256, 64,
             None]


@pytest.fixture(autouse=True)
def _fresh_caches():
    ttab.clear_cache()
    jtab.clear_cache()
    yield
    ttab.clear_cache()
    jtab.clear_cache()


def _both(kernel, N, key, path):
    """(the port's row, the reference's row) under one key: the port
    takes the key, the reference an ExecMode of that backend and mode."""
    ttab.clear_cache()
    jtab.clear_cache()
    backend, mode = key.split("/")
    jmode = MODES.get(key) or ExecMode("auto", mode, backend, True, None,
                                       "x")
    return (ttab.best_config(kernel, N, key, path=path),
            jtab.best_config(kernel, N, jmode, path=path))


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_best_config_is_the_references(tmp_path, writer, case):
    """The same row from the same file, whichever package wrote it."""
    path = tmp_path / "tuned.json"
    (ttab if writer == "port" else jtab).write_table(ENTRIES, path)
    kernel, N, key = CASES[case]
    port, ref = _both(kernel, N, key, path)
    assert port == ref
    assert port.get("lane_tile") == WANT_TILE[case]


@pytest.mark.parametrize("text", ["", "{not json", json.dumps(dict(
    format=999, entries=ENTRIES)), json.dumps(dict(entries=ENTRIES))])
def test_a_broken_table_gives_nothing(tmp_path, text):
    path = tmp_path / "tuned.json"
    path.write_text(text)
    for key in ("cpu/interpret", CARD):
        assert _both("katana_bank_sequence", 64, key, path) == ({}, {})
    missing = tmp_path / "absent.json"
    assert _both("katana_bank", 64, "cpu/interpret", missing) == ({}, {})


def test_helpers_fall_back_to_the_default(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    ttab.write_table({"katana_bank": {"cpu/plain": [
        dict(N=64, lane_tile=0, us_per_frame=1.0)]}}, path)
    monkeypatch.setattr(ttab, "TUNED_PATH", path)
    assert ttab.tuned_lane_tile("katana_bank", 64, 128, "cpu") == 128
    assert ttab.tuned_time_chunk("katana_bank", 64, 4096, "cpu") == 4096
    assert ttab.tuned_lane_tile("katana_bank_imm", 64, 128, "cpu") == 128


def test_device_key():
    assert ttab.device_key("cpu") == "cpu/plain"
    assert ttab.device_key(torch.device("cpu")) == "cpu/plain"
    with pytest.raises(ValueError):
        ttab.device_key("meta")
    if torch.cuda.is_available():
        assert ttab.device_key("cuda") == (
            f"cuda/{torch.cuda.get_device_name(0)}")


def test_static_defaults_are_the_launches_before_the_table():
    assert ttab.STATIC_DEFAULTS == {
        "katana_bank": dict(lane_tile=128),
        "katana_bank_imm": dict(lane_tile=128),
        "imm_bank_sequence": dict(lane_tile=128),
        "katana_bank_sequence": dict(lane_tile=128, time_chunk=4096),
        "katana_imm_sequence": dict(lane_tile=32, time_chunk=4096)}
    assert set(ttab.STATIC_DEFAULTS) == set(jtab.STATIC_DEFAULTS)
    for kernel, cfg in ttab.STATIC_DEFAULTS.items():
        assert cfg["lane_tile"] in tops.LANE_TILES[kernel]


def test_checked_in_table_is_well_formed():
    """The card's table: this format, known kernels, ``cuda/`` keys only,
    instantiated tiles, positive chunks and times; the tuner's kernels at
    the port's three bank sizes."""
    doc = json.loads(ttab.TUNED_PATH.read_text())
    assert doc["format"] == ttab.TABLE_FORMAT
    assert ttab.TUNED_PATH != jtab.TUNED_PATH
    assert set(tune.KERNELS) <= set(doc["entries"])
    for kernel, by_key in doc["entries"].items():
        assert kernel in ttab.STATIC_DEFAULTS, kernel
        for key, rows in by_key.items():
            assert key.startswith("cuda/"), key
            assert sorted(r["N"] for r in rows) == [1024, 8192, 131072]
            for r in rows:
                assert r["lane_tile"] in tops.LANE_TILES[kernel], r
                if "time_chunk" in ttab.STATIC_DEFAULTS[kernel]:
                    assert r["time_chunk"] in tune.TIME_CHUNKS, r
                assert r["us_per_frame"] > 0
                assert r["static_us_per_frame"] >= r["us_per_frame"]


@pytest.fixture
def port_table(tmp_path, monkeypatch):
    """A table of ``cpu/plain`` rows pinning tiles and chunks other than
    the static defaults, as TUNED_PATH."""
    path = tmp_path / "tuned.json"
    ttab.write_table({
        "katana_bank": {"cpu/plain": [dict(N=8, lane_tile=64,
                                           us_per_frame=1.0)]},
        "katana_bank_imm": {"cpu/plain": [dict(N=32, lane_tile=256,
                                               us_per_frame=1.0)]},
        "imm_bank_sequence": {"cpu/plain": [dict(N=32, lane_tile=64,
                                                 us_per_frame=1.0)]},
        "katana_bank_sequence": {"cpu/plain": [
            dict(N=8, lane_tile=256, time_chunk=7, us_per_frame=1.0)]},
        "katana_imm_sequence": {"cpu/plain": [
            dict(N=8, lane_tile=64, time_chunk=5, us_per_frame=1.0)]},
    }, path)
    monkeypatch.setattr(ttab, "TUNED_PATH", path)
    return path


def _stream(kind, N=8, T=24):
    jm, tm, _, _ = models(kind)
    x0, P0, zs, _ = replay_inputs(np.random.default_rng(N + T), tm, N, T,
                                  extent=1.0)
    return jm, tm, [torch.as_tensor(a) for a in (x0, P0, zs)], (x0, P0, zs)


@pytest.mark.parametrize("name,kind", [
    ("katana_bank", "lkf"), ("katana_bank_imm", "imm"),
    ("imm_bank_sequence", "imm"), ("katana_bank_sequence", "lkf"),
    ("katana_imm_sequence", "imm"), ("katana_bank_soa", "lkf")])
def test_zero_resolves_through_the_table(port_table, name, kind):
    """lane_tile=0 / time_chunk=0 take the row of cpu/plain (the SoA step
    the static tile: the tuner races no SoA layout); an explicit tile and
    chunk win; LAST_CONFIG shows what each call used."""
    _, tm, (x0, P0, zs), _ = _stream(kind)
    T, N, _ = zs.shape
    K = getattr(tm, "K", 1)
    xK = x0[None].expand(K, N, tm.n).contiguous()
    PK = P0[None].expand(K, N, tm.n, tm.n).contiguous()
    call = {
        "katana_bank": lambda **kw: tops.katana_bank(tm, x0, P0, zs[0],
                                                     **kw),
        "katana_bank_soa": lambda **kw: tops.katana_bank_soa(
            tm, x0.T.contiguous(), P0.permute(1, 2, 0).contiguous(),
            zs[0].T.contiguous(), **kw),
        "katana_bank_imm": lambda **kw: tops.katana_bank_imm(tm, xK, PK,
                                                             zs[0], **kw),
        "imm_bank_sequence": lambda **kw: tops.imm_bank_sequence(
            tm, zs[:3], x0, P0, **kw),
        "katana_bank_sequence": lambda **kw: tops.katana_bank_sequence(
            tm, zs, x0, P0, **kw),
        "katana_imm_sequence": lambda **kw: tops.katana_imm_sequence(
            tm, zs, x0, P0, **kw)}[name]
    row = ttab.best_config(name, None, "cpu/plain")
    default = call()
    cfg = tops.LAST_CONFIG[name]
    assert cfg["key"] == "cpu/plain"
    want_tile = 128 if name == "katana_bank_soa" else row["lane_tile"]
    assert cfg["lane_tile"] == want_tile
    assert cfg["time_chunk"] == row.get("time_chunk")
    if name == "imm_bank_sequence":
        # its tile goes on to every katana_bank_imm
        assert tops.LAST_CONFIG["katana_bank_imm"]["lane_tile"] == 64
    table = "katana_bank" if name == "katana_bank_soa" else name
    explicit = dict(lane_tile=ttab.STATIC_DEFAULTS[table]["lane_tile"])
    if cfg["time_chunk"] is not None:
        explicit["time_chunk"] = 11
    pinned = call(**explicit)
    assert tops.LAST_CONFIG[name]["lane_tile"] == explicit["lane_tile"]
    assert tops.LAST_CONFIG[name]["time_chunk"] == explicit.get("time_chunk")
    # the tile and the chunk are launch choices: the same bits
    for a, b in zip(_flat(default), _flat(pinned)):
        assert torch.equal(a, b)


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


@pytest.mark.parametrize("name,tile", [
    ("katana_bank", 32), ("katana_bank", 512), ("katana_bank_sequence", 32),
    ("katana_imm_sequence", 128), ("katana_bank_imm", 96)])
def test_a_tile_not_instantiated_raises(name, tile):
    _, tm, (x0, P0, zs), _ = _stream("imm" if "imm" in name else "lkf")
    K = getattr(tm, "K", 1)
    call = {
        "katana_bank": lambda: tops.katana_bank(tm, x0, P0, zs[0],
                                                lane_tile=tile),
        "katana_bank_sequence": lambda: tops.katana_bank_sequence(
            tm, zs, x0, P0, lane_tile=tile),
        "katana_imm_sequence": lambda: tops.katana_imm_sequence(
            tm, zs, x0, P0, lane_tile=tile),
        "katana_bank_imm": lambda: tops.katana_bank_imm(
            tm, x0[None].expand(K, -1, -1).contiguous(),
            P0[None].expand(K, -1, -1, -1).contiguous(), zs[0],
            lane_tile=tile)}[name]
    with pytest.raises(ValueError, match=str(tops.LANE_TILES[name])[1:-1]):
        call()


def test_a_bad_table_tile_raises(tmp_path, monkeypatch):
    """No fallback: a tabled tile the kernel lacks fails the call."""
    path = tmp_path / "tuned.json"
    ttab.write_table({"katana_bank_sequence": {"cpu/plain": [
        dict(N=8, lane_tile=96, time_chunk=8, us_per_frame=1.0)]}}, path)
    monkeypatch.setattr(ttab, "TUNED_PATH", path)
    _, tm, (x0, P0, zs), _ = _stream("lkf")
    with pytest.raises(ValueError, match="lane_tile 96"):
        tops.katana_bank_sequence(tm, zs, x0, P0)


def test_the_k1_imm_replay_takes_the_scans_tiles_and_rows(port_table):
    _, tm, (x0, P0, zs), _ = _stream("lkf")
    one = tops.katana_imm_sequence(tf_as_imm(tm), zs, x0, P0)
    cfg = tops.LAST_CONFIG["katana_imm_sequence"]
    assert (cfg["table"], cfg["lane_tile"], cfg["time_chunk"]) == (
        "katana_bank_sequence", 256, 7)
    assert torch.equal(one, tops.katana_bank_sequence(tm, zs, x0, P0))
    with pytest.raises(ValueError, match="64, 128, 256"):
        tops.katana_imm_sequence(tf_as_imm(tm), zs, x0, P0, lane_tile=32)


def tf_as_imm(model):
    from repro_torch.core.filters import as_imm

    return as_imm(model)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_a_tabled_chunk_is_one_chunks_bits_and_the_references(port_table,
                                                              kind):
    """The tabled chunk (7 frames; 5 for the IMM) splits the CPU path into
    launches whose result is the one-chunk result bit for bit, and within
    1e-5 of the reference's ops at its own tuned defaults."""
    jm, tm, (x0, P0, zs), raw = _stream(kind)
    T = zs.shape[0]
    if kind == "imm":
        name, seq, jseq = ("katana_imm_sequence", tops.katana_imm_sequence,
                           jops.katana_imm_sequence)
    else:
        name, seq, jseq = ("katana_bank_sequence",
                           tops.katana_bank_sequence,
                           jops.katana_bank_sequence)
    got, fin = seq(tm, zs, x0, P0, return_final=True)
    chunk = tops.LAST_CONFIG[name]["time_chunk"]
    assert chunk == (5 if kind == "imm" else 7) and chunk < T
    one, fin1 = seq(tm, zs, x0, P0, return_final=True, time_chunk=T)
    assert torch.equal(got, one)
    assert all(torch.equal(a, b) for a, b in zip(fin, fin1))
    import jax.numpy as jnp

    x0n, P0n, zsn = raw
    want = jseq(jm, jnp.asarray(zsn), jnp.asarray(x0n), jnp.asarray(P0n))
    want = np.asarray(want, np.float64)
    err = (np.abs(np_(got).astype(np.float64) - want)
           / np.maximum(1.0, np.abs(want))).max()
    assert err <= 1e-5, err


def test_best_picks_the_least_and_skips_a_raise(capsys):
    times = {64: 3.0, 128: 1.5, 256: 2.0}

    def measure(lane_tile):
        if lane_tile == 256:
            raise RuntimeError("refused")
        return times[lane_tile]
    best = tune._best([dict(lane_tile=t) for t in (64, 128, 256)], measure)
    assert best == dict(lane_tile=128, us_per_frame=1.5)
    assert "skip {'lane_tile': 256}: RuntimeError: refused" in (
        capsys.readouterr().out)
    assert tune._best([dict(lane_tile=64)],
                      lambda **kw: 1 / 0) is None


def _fake_measure(kernel, N, lane_tile, time_chunk=None):
    """µs a frame whose best is tile 64 (and chunk 150) at N = 8,192, the
    static default elsewhere."""
    static = tune.static_config(kernel)
    if N == 8192:
        return 1.0 if lane_tile == 64 and time_chunk in (None, 150) else 2.0
    same = lane_tile == static["lane_tile"] and time_chunk == static.get(
        "time_chunk")
    return 1.0 if same else 2.0 + lane_tile / 1e3


def test_tune_with_an_injected_measure():
    report = []
    entries = tune.tune(Ns=(1024, 8192), T=300, device="cpu",
                        measure=_fake_measure, report=report)
    assert set(entries) == set(tune.KERNELS)
    assert len(report) == 2 * sum(len(tune.candidates(k))
                                  for k in tune.KERNELS)
    for kernel in tune.KERNELS:
        rows = entries[kernel]["cpu/plain"]
        assert [r["N"] for r in rows] == [1024, 8192]
        static = tune.static_config(kernel)
        assert rows[0]["lane_tile"] == static["lane_tile"]
        assert rows[0]["us_per_frame"] == rows[0]["static_us_per_frame"]
        assert rows[1]["lane_tile"] == 64
        assert rows[1]["static_us_per_frame"] == 2.0
        if "time_chunk" in static:
            assert rows[0]["time_chunk"] == static["time_chunk"]
            assert rows[1]["time_chunk"] == 150


def test_merge_keeps_other_keys_and_kernels():
    old = {"katana_bank": {"cpu/interpret": [dict(N=1, lane_tile=64)],
                           CARD: [dict(N=2, lane_tile=64)]},
           "imm_bank_sequence": {CARD: [dict(N=3, lane_tile=128)]}}
    new = {"katana_bank": {CARD: [dict(N=4, lane_tile=256)]},
           "katana_bank_sequence": {CARD: [dict(N=5, lane_tile=64)]}}
    merged = tune.merge(new, old)
    assert merged["katana_bank"] == {
        "cpu/interpret": [dict(N=1, lane_tile=64)],
        CARD: [dict(N=4, lane_tile=256)]}
    assert merged["imm_bank_sequence"] == old["imm_bank_sequence"]
    assert merged["katana_bank_sequence"] == new["katana_bank_sequence"]
    assert old["katana_bank"][CARD] == [dict(N=2, lane_tile=64)]


def test_main_dry_run_writes_nothing_and_a_run_merges(tmp_path,
                                                      monkeypatch):
    real = tune.tune
    monkeypatch.setattr(tune, "tune",
                        lambda **kw: real(measure=_fake_measure, **kw))
    path = tmp_path / "tuned.json"
    args = ["--device", "cpu", "--Ns", "8192", "--T", "30", "--rounds", "1",
            "--out", str(path)]
    tune.main(args + ["--dry-run"])
    assert not path.exists()
    jtab.write_table({"katana_bank": {"cpu/interpret": [
        dict(N=64, lane_tile=64, us_per_frame=1.0)]}}, path)
    tune.main(args)
    doc = json.loads(path.read_text())
    assert doc["entries"]["katana_bank"]["cpu/interpret"] == [
        dict(N=64, lane_tile=64, us_per_frame=1.0)]
    assert doc["entries"]["katana_bank"]["cpu/plain"][0]["lane_tile"] == 64
    # the reference's loader reads what the tuner wrote
    assert jtab.best_config("katana_bank", 64, MODES["cpu/interpret"],
                            path=path)["lane_tile"] == 64



def test_the_tuner_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(SystemExit, match="--device cpu"):
        tune.main(["--dry-run"])


def test_the_tuner_races_the_instantiated_tiles():
    assert tune.candidates("katana_bank") == [
        dict(lane_tile=t) for t in (64, 128, 256)]
    assert len(tune.candidates("katana_bank_sequence")) == 9
    assert tune.candidates("katana_imm_sequence")[0] == dict(
        lane_tile=32, time_chunk=64)
    for kernel in tune.KERNELS:
        assert tune.static_config(kernel) in tune.candidates(kernel)


@pytest.mark.parametrize("source,macro,kernels", [
    ("scan.cu", "KATANA_SCAN_TILES", ("katana_bank_sequence",)),
    ("imm_step.cu", "KATANA_STEP_TILES",
     ("katana_bank", "katana_bank_imm", "imm_bank_sequence")),
    ("imm_scan.cu", "KATANA_IMM_SCAN_TILES", ("katana_imm_sequence",))])
def test_lane_tiles_are_the_sources_instantiations(source, macro, kernels):
    """ops.LANE_TILES is what each source instantiates, and a source the
    build splits has a part a tile."""
    import re

    from repro_torch.kernels import build

    text = (build.SOURCES[source] / source).read_text()
    line = re.search(rf"#define {macro}\(X\)(.*)", text).group(1)
    tiles = tuple(int(t) for t in re.findall(r"X\((\d+)\)", line))
    for kernel in kernels:
        assert tops.LANE_TILES[kernel] == tiles
    assert build.PARTS.get(source, 1) in (1, len(tiles))


def test_a_split_source_builds_its_parts_then_links(tmp_path, monkeypatch):
    """build.PARTS sources: one compile a part at once (-c, -DKATANA_PART=i,
    no -shared), their logs kept, then one link of the objects; the
    objects removed. A stand-in compiler records its command lines."""
    import sys

    from repro_torch.kernels import build

    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls.txt"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('x')\n"
        "if '-shared' not in sys.argv:\n"
        "    print(\"ptxas info    : Compiling entry function 'k'\")\n"
        "    print('ptxas info    : Used 64 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "BUILD_LOG", {})
    logs = build.build(["scan.cu", "greedy.cu"])
    lines = calls.read_text().splitlines()
    parts = [ln for ln in lines if "-DKATANA_PART=" in ln]
    assert sorted(ln.split("-DKATANA_PART=")[1].split()[0]
                  for ln in parts) == ["0", "1", "2"]
    assert all(" -c " in f" {ln} " and "-shared" not in ln.split()
               for ln in parts)
    link = [ln for ln in lines if ln.startswith("-shared")]
    assert len(link) == 1 and link[0].count(".o") == 3
    assert len(lines) == 5  # 3 parts, their link, greedy.cu whole
    assert len([ln for ln in logs["scan.cu"]["ptxas"] if "Used" in ln]) == 3
    assert build.lib_path("scan.cu").exists()
    assert not list((tmp_path / "kernels").glob("*.o"))
