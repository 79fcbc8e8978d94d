"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to run
without a GPU (no result line, non-zero exit)."""

import subprocess

import pytest

import chip_smoke
from dctpu.codec.api import build_blocks
from dctpu.format import write_raw

L = 256


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    streams, ids, cads = chip_smoke.make_corpus(6, 3 * L + 70, seed=5)
    dcr = tmp_path_factory.mktemp("corpus") / "corpus.dcr"
    dcr.write_bytes(write_raw(streams, ids, cads))
    return streams, ids, cads, dcr


@pytest.fixture(scope="module")
def refs(corpus):
    oracle = chip_smoke.build_oracle()
    return chip_smoke.oracle_frames(oracle, corpus[3], block_len=L)


@pytest.fixture(scope="module")
def stages(corpus):
    x, n, hist, _, _ = build_blocks(corpus[0], L)
    return chip_smoke.phase_compile(x[:16], n[:16], hist[:16], block_len=L)


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_main_four_exits_nonzero_without_gpu(capsys, monkeypatch):
    def no_smi():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(chip_smoke, "card_lines", no_smi)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--four"])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("op,want", [
    (lambda b, i, v: b.at[i].add(v), "add"),
    (lambda b, i, v: b.at[i].max(v), "maximum"),
    (lambda b, i, v: b.at[i].set(v), "parameter"),
])
def test_scatter_combiners(op, want):
    import jax
    import jax.numpy as jnp

    hlo = jax.jit(op).lower(
        jnp.zeros(16, jnp.int32), jnp.array([1, 1, 3], jnp.int32),
        jnp.array([4, 5, 6], jnp.int32),
    ).compile().as_text()
    assert chip_smoke.scatter_combiners(hlo) == [want]


def test_phase_compile_covers_entry_points(stages):
    names = [name for name, _, _ in stages]
    assert names == [
        "encode_blocks[rice]", "encode_blocks[vertical]", "adaptive_select",
        "emit_blocks[rice]", "compact_rice_semi", "stage_rice_scan_device",
        "decode_blocks[rice]", "emit_blocks[vertical]",
        "compact_vertical_semi", "stage_vertical_device",
        "decode_blocks[vertical]",
    ]


def test_phase_round_trips_match_oracle_and_scalar(corpus, refs, capsys):
    streams, ids, cads, _ = corpus
    frames = chip_smoke.phase_round_trips(
        streams, ids, cads, refs, block_len=L, n_scalar=2)
    assert frames == refs
    assert capsys.readouterr().out.count("decode bit-exact") == 3


def test_phase_round_trips_catches_mismatch(corpus, refs):
    streams, ids, cads, _ = corpus
    bad = dict(refs)
    bad["rice"] = bad["rice"][:-1] + bytes([bad["rice"][-1] ^ 1])
    with pytest.raises(AssertionError, match="oracle"):
        chip_smoke.phase_round_trips(
            streams, ids, cads, {"rice": bad["rice"]}, block_len=L)


def test_frame_prefix_is_a_frame_of_the_prefix(corpus):
    from dctpu.codec import compress, scalar_compress
    from dctpu.config import CodecConfig
    from dctpu.format import write_frame

    streams, ids, cads, _ = corpus
    cfg = CodecConfig(block_len=L, coder="adaptive")
    frame = compress(streams, cfg, stream_ids=ids, cadences=cads)
    want = write_frame(scalar_compress(streams[:3], cfg, stream_ids=ids[:3],
                                       cadences=cads[:3]))
    assert write_frame(chip_smoke.frame_prefix(frame, 3)) == want


def test_phase_cli_verify(corpus, capsys):
    chip_smoke.phase_cli_verify(corpus[3], block_len=L)
    assert "CLI verify: OK" in capsys.readouterr().out


def test_phase_stage_times(stages, corpus, capsys):
    streams, ids, cads, _ = corpus
    chip_smoke.phase_stage_times(stages, streams, ids, cads, "cpu test",
                                 block_len=L, reps=1)
    out = capsys.readouterr().out
    assert out.count("stage ") == len(stages)
    assert out.count("end-to-end ") == 3
    assert "peak_bytes_in_use" in out


def test_phase_sharded_matches_oracle(corpus, refs):
    import jax

    streams, ids, cads, _ = corpus
    chip_smoke.phase_sharded(streams, ids, cads, refs, jax.devices()[:4],
                             block_len=L)


def test_phase_multihost_matches_oracle(corpus, tmp_path):
    streams, ids, cads, dcr = corpus
    oracle = chip_smoke.build_oracle()
    refs = chip_smoke.oracle_frames(oracle, dcr, coders=("rice",))
    chip_smoke.phase_multihost(dcr, refs, nproc=2, platform="cpu",
                               timeout=300)


def test_result_line_names_the_device():
    import json

    import jax

    line = json.loads(chip_smoke.result_line(jax.devices()[:1]))
    assert line == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind, "count": 1}}


def test_oracle_build_from_source():
    path = chip_smoke.build_oracle()
    r = subprocess.run([path], capture_output=True, text=True)
    assert r.returncode != 0 and "usage" in r.stderr
