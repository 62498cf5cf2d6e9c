"""The five ``examples/*_torch.py`` on the CPU against the JAX package's
examples.

* quickstart, policy_compare and smart_city: each port example runs with
  ``--device cpu`` and its printout is compared with the JAX example's,
  line by line and number by number (wall times excluded; the printed
  numbers agree at rtol 1e-6, the tolerance of ROADMAP C5's metrics).
* serve_batch: with the JAX example's weights and prompts carried across
  (``repro_torch.models.convert``), the port's greedy continuation ids are
  the JAX example's, and its pod-scale prediction lines are identical.
* train_lm: three steps with ``--device cpu``, finite and falling loss (the
  example asserts both; training parity is ``test_torch_train.py``'s).

Each example runs in a subprocess with its own time limit, in a temporary
working directory (smart_city's Part 7 writes its trace there)."""
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
NUM = re.compile(r"[-+]?\d[\d,]*\.?\d*(?:[eE][-+]?\d+)?")
# lines whose numbers are wall times or rates
TIMED = re.compile(r" ms\b|scenarios/s|tok/s")


def _run(script: str, *args, cwd, jax_env=False, timeout=300) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, str(EX / script), *args], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(cwd))
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.splitlines()


def _numbers(line: str) -> list[float]:
    return [float(m.replace(",", "")) for m in NUM.findall(line)]


def _same_printout(want: list[str], got: list[str]):
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(want, got):
        if TIMED.search(a):
            assert TIMED.search(b), (a, b)
            continue
        na, nb = _numbers(a), _numbers(b)
        assert len(na) == len(nb), (a, b)
        np.testing.assert_allclose(nb, na, rtol=1e-6, atol=0,
                                   err_msg=f"\n{a}\n{b}")


@pytest.mark.parametrize("name,args", [
    ("quickstart", ()),
    ("policy_compare", ()),
    ("smart_city", ("--trace", "smart_city_trace.json")),
])
def test_example_printout_matches_jax(name, args, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _run(f"{name}.py", cwd=tmp_path / "jax", jax_env=True)
    got = _run(f"{name}_torch.py", "--device", "cpu", *args,
               cwd=tmp_path / "torch")
    _same_printout(want, got)
    if name == "smart_city":
        # Part 7's timeline, event for event
        doc = {k: json.loads((tmp_path / k / "smart_city_trace.json")
                             .read_text()) for k in ("jax", "torch")}
        assert doc["torch"]["traceEvents"] == doc["jax"]["traceEvents"]


def test_serve_batch_matches_jax_with_its_weights(tmp_path):
    import jax

    from repro.models import ArchConfig as JArch
    from repro.models import decode_step as j_decode
    from repro.models import init_model as j_init
    from repro.models import prefill as j_prefill
    from repro_torch.models import convert
    sys.path.insert(0, str(EX))
    try:
        import serve_batch_torch as port
    finally:
        sys.path.remove(str(EX))
    cfg = JArch(**{f: getattr(port.CFG, f)
                   for f in ("name", "family", "n_layers", "d_model",
                             "n_heads", "n_kv_heads", "d_ff", "vocab",
                             "vocab_pad_to", "dtype")})
    B, S, DEC = port.B, port.S, port.DEC
    params = j_init(jax.random.PRNGKey(0), cfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab)
    # the JAX example's continuation, step for step
    logits, state = j_prefill(params, cfg, prompts, S + DEC)
    toks = jax.numpy.argmax(logits, -1)
    ids = [toks]
    for t in range(S, S + DEC):
        logits, state = j_decode(params, cfg, toks, state, t)
        toks = jax.numpy.argmax(logits, -1)
        ids.append(toks)
    want_ids = np.asarray(jax.numpy.stack(ids, 1))

    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got_ids, _ = port.main("cpu", tparams, np.array(prompts))
    np.testing.assert_array_equal(got_ids, want_ids)

    want = _run("serve_batch.py", cwd=tmp_path, jax_env=True)
    got = buf.getvalue().splitlines()
    assert len(got) == len(want)
    for a, b in zip(want, got):
        if not TIMED.search(a):
            assert a == b, (a, b)     # ids and the prediction, verbatim


def test_train_lm_falls_in_three_steps(tmp_path):
    out = _run("train_lm_torch.py", "--device", "cpu", "--steps", "3",
               "--ckpt-dir", str(tmp_path / "ck"), cwd=tmp_path)
    line = next(ln for ln in out if ln.startswith("loss:"))
    first, last, final = _numbers(line.replace("first3", "").replace(
        "last3", ""))
    assert np.isfinite([first, last, final]).all()
    assert final < first
    assert any((tmp_path / "ck").rglob("*")), "no checkpoint committed"
