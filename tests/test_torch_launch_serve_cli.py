"""The serving launcher (``python -m repro_torch.launch.serve``) on the CPU
against the reference's (``repro.launch.serve.main``) on the same
arguments: reduced granite-3-8b, 6 requests under a pool of 10 slots, the
reference's weights (its ``init_params(PRNGKey(0))``, carried over through
``bridge``) and prompts (``default_rng(0)`` in both).  Every printed line
is equal but for ``wall=`` and the port's own ``d2h=``/``h2d=``, which
must be the engine's byte counters, its host arena's ``arena=``,
``peak=`` and ``host_pages=`` (no launch on the CPU), and its dropless
MoE counts ``moe=`` (none: granite has no MoE).  And ``--dryrun``: one rank's decode cell on
the meta device, an ``ok`` record, exit 0."""
import json
import re
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

ARGS = ["--arch", "granite-3-8b", "--local", "--requests", "6", "--max-new", "8",
        "--pool-slots", "10", "--max-batch", "3", "--page", "4"]


def _lines(text):
    return [re.sub(r"wall=\S+", "wall=", line) for line in text.splitlines()]


def _host_bytes(lines):
    """The port's ``d2h=``/``h2d=`` (MB), its arena's pages in use,
    capacity, peak and kernel launches, and its MoE entries and groups,
    taken off the third line."""
    m = re.search(r" d2h=(\S+)MB h2d=(\S+)MB arena=(\d+)/(\d+) peak=(\d+) "
                  r"host_pages=(\d+) moe=(\d+)/(\d+)$", lines[2])
    assert m, lines[2]
    lines[2] = lines[2][:m.start()]
    return (float(m.group(1)), float(m.group(2)),
            tuple(int(m.group(i)) for i in range(3, 7)),
            (int(m.group(7)), int(m.group(8))))


def test_local_run_prints_what_the_reference_prints(monkeypatch, capsys):
    from repro.configs import get_arch as ref_get_arch
    from repro.configs import reduced as ref_reduced
    from repro.launch import serve as ref_serve
    from repro.models import transformer as ref_T
    from repro_torch import bridge
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    monkeypatch.setattr(sys, "argv", ["serve"] + ARGS)
    assert ref_serve.main() == 0
    want = _lines(capsys.readouterr().out)

    numpy_params = jax.tree.map(np.asarray, ref_T.init_params(
        jax.random.PRNGKey(0), ref_reduced(ref_get_arch("granite-3-8b"))))
    monkeypatch.setattr(T, "init_params",
                        lambda cfg, generator=None, device="cpu", **kw:
                        bridge.to_torch(numpy_params, device))
    from repro_torch import serve as serve_pkg
    engines, real = [], serve_pkg.ValetServeEngine

    def keep(*a, **kw):
        engines.append(real(*a, **kw))
        return engines[-1]
    monkeypatch.setattr(serve_pkg, "ValetServeEngine", keep)
    assert serve.main(ARGS + ["--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    d2h, h2d, arena, moe = _host_bytes(got)
    assert len(want) == 7 and want[0].startswith("policy=valet requests=6")
    assert got == want
    st = engines[0].stats
    assert (d2h, h2d) == (round(st.d2h_bytes / 1e6, 3), round(st.h2d_bytes / 1e6, 3))
    assert st.d2h_bytes > 0 and st.h2d_bytes > 0
    a = engines[0].arena
    assert arena == (a.in_use, a.capacity, a.peak, 0) and a.peak > 0
    assert "pauses=0 " not in want[1]          # the pool was under pressure
    assert moe == (st.moe_entries, st.moe_groups) == (0, 0)


def test_seed_is_gone():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(ARGS + ["--seed", "1"])


def test_dryrun_writes_an_ok_record(monkeypatch, tmp_path):
    from repro_torch.launch import dryrun, serve
    monkeypatch.setattr(dryrun, "_artifact_dir", lambda: str(tmp_path))
    assert serve.main(["--arch", "granite-3-8b", "--dryrun"]) == 0
    rec = json.loads((tmp_path / "single" / "granite-3-8b__decode_32k.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["shape"] == "decode_32k"
    # a shape that does not apply: the skip record, exit 1 as the reference
    assert serve.main(["--arch", "granite-3-8b", "--dryrun",
                       "--shape", "long_500k"]) == 1
