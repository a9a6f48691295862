"""Generation checkpoints above tp 1 (runtime/checkpoint.py under a tp
group; twin: the JAX package's runtime/checkpoint.py, whose file a tp 4 run
restores at tp 8 and back): a generation split at tp 1, 2 or 4 and
resumed at each other tp gives one uninterrupted run's stream, the file
holding the kv heads in global order; a JAX CLI tp 2 checkpoint resumes in
the port's CLI and the port's in the JAX CLI, each joined stream the
uninterrupted one."""

import os
import pickle
import subprocess
import sys

import pytest

from test_torch_tp_cli import ROOT, SPEC, _pieces, model_files  # noqa: F401

PROMPT = "hi hi hi"
FIRST, TOTAL = 7, 20   # positions before the split, and in all
SIZES = (1, 2, 4)


def _rank(rank, world, port, out, model, tok, ckdir):
    """One gloo rank of 4 (the first 2 a subgroup): save at each tp, then
    resume every checkpoint at every other tp; rank 0 pickles the
    uninterrupted stream, each split's first part and each joined
    stream."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.parallel.mesh import TPGroup
    from distributed_llama_tpu_torch.parallel.tp import load_model_bands
    from distributed_llama_tpu_torch.runtime import checkpoint
    from distributed_llama_tpu_torch.runtime.generate import (Engine,
                                                              generate)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    groups = {2: dist.new_group([0, 1]), 4: dist.group.WORLD}
    cpu = torch.device("cpu")

    def engine(tp):
        if tp == 1:
            spec, params = load_model(model, weights_float_type=FloatType.Q40)
            return Engine(spec, params, "cpu")
        spec, params = load_model_bands(model, rank, tp, "fused",
                                        FloatType.Q40)
        return Engine(spec, params, "cpu",
                      group=TPGroup(rank, tp, groups[tp], cpu),
                      scheme="fused")

    def sampler(seed=7):
        return Sampler(SPEC.vocab_size, 0.8, 0.9, seed)

    tokenizer = Tokenizer(tok, SPEC.vocab_size)
    res = {}
    with torch.inference_mode():
        if rank == 0:
            res["whole"], _ = generate(engine(1), tokenizer, sampler(),
                                       PROMPT, TOTAL, quiet=True)
        for tp in SIZES:
            if rank < tp:
                eng, s = engine(tp), sampler()
                first, st = generate(eng, tokenizer, s, PROMPT, FIRST,
                                     quiet=True)
                path = os.path.join(ckdir, f"tp{tp}.npz")
                checkpoint.save_generation_state(
                    path, eng, s, st.final_pos, st.final_token, first,
                    st.prompt_rest)
                res[("first", tp)] = first
                if rank == 0:
                    res[("heads", tp)] = np.load(path)["k"].shape
            dist.barrier()
        for saved in SIZES:
            for tp in SIZES:
                if tp != saved and rank < tp:
                    eng, s = engine(tp), sampler(seed=123)
                    cache_k = eng.cache.k
                    pos, token, prev, rest = checkpoint.load_generation_state(
                        os.path.join(ckdir, f"tp{saved}.npz"), eng, s)
                    assert eng.cache.k is cache_k  # in place
                    more, _ = generate(eng, tokenizer, s, "IGNORED",
                                       TOTAL - pos, quiet=True,
                                       resume=(pos, token),
                                       resume_prompt=rest)
                    res[(saved, tp)] = prev + more
                dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)


@pytest.fixture(scope="module")
def splits(model_files, tmp_path_factory):
    from test_torch_tp import spawn_ranks

    model, tok, _ = model_files
    d = tmp_path_factory.mktemp("ck")
    return spawn_ranks(_rank, 4, d / "res.pkl", model, tok, str(d))


@pytest.mark.parametrize("saved", SIZES)
def test_a_split_at_one_tp_joins_at_every_other(splits, saved):
    whole = splits["whole"]
    assert len(whole) > FIRST + 6
    assert splits[("first", saved)] == whole[:len(splits[("first", saved)])]
    # the file holds every kv head, whatever tp wrote it
    assert splits[("heads", saved)][2] == SPEC.n_kv_heads
    for tp in SIZES:
        if tp != saved:
            assert splits[(saved, tp)] == whole, (saved, tp)


def _cli(argv):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", "distributed_llama_tpu_torch",
                          *argv, "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tp2_checkpoints_cross_between_the_clis(model_files, capfd,
                                                tmp_path, writer):
    from distributed_llama_tpu.frontend.cli import main as ref_main

    model, tok, _ = model_files
    base = ["inference", "--model", model, "--tokenizer", tok, "--tp", "2",
            "--temperature", "0.8", "--topp", "0.9", "--seed", "42"]
    assert ref_main(base + ["--prompt", PROMPT, "--steps", str(TOTAL)]) == 0
    whole = _pieces(capfd.readouterr().out)
    assert len(whole) > FIRST + 6
    path = str(tmp_path / "state.npz")
    first = base + ["--prompt", PROMPT, "--steps", str(FIRST),
                    "--save-state", path]
    rest = base + ["--resume-state", path, "--steps", str(TOTAL - FIRST)]
    if writer == "jax":
        assert ref_main(first) == 0
        out1 = capfd.readouterr().out
        out2 = _cli(rest)
    else:
        out1 = _cli(first)
        assert ref_main(rest) == 0
        out2 = capfd.readouterr().out
    assert "Saved generation state" in out1
    assert f"Resumed at pos {FIRST}" in out2
    assert _pieces(out1) + _pieces(out2) == whole
