"""``models.attention.call_flash`` on four gloo ranks on the CPU: where q's
heads are sharded and k's are not (fewer kv heads than ranks on the
mesh dim, as llama3-8b's 8 at tp 16), each rank keeps its query heads and
takes the kv heads they read, forward and backward, and the result equals
the plain version's on the whole tensors.

One spawned group of four ranks (``tests/torch_call_flash_worker.py``,
under a 200 s limit that is also its process group's timeout, meeting through a
``FileStore`` in a temporary directory) runs every case.  Per case: the
gathered output and the gradients of q, k and v within 1e-5 of their
largest entry of the plain version's (fp32), and the (query heads, kv
heads) of each rank's kernel call.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The ranks' limit and their process groups' timeout: at least three times
#: the fixture's wall under the suite's own load (``-n 6 --dist loadfile``,
#: 12-62 s), so a slow run finishes and a hang still fails.
LIMIT_S = 200

#: name -> ((data, model) mesh, heads, kv heads, window, the (query heads,
#: kv heads) each rank's kernel call takes)
CASES = {
    "8 heads, 1 kv head, (2, 2)": ((2, 2), 8, 1, None, [4, 1]),
    "8 heads, 2 kv heads, (1, 4)": ((1, 4), 8, 2, None, [2, 1]),
    "16 heads, 2 kv heads, (1, 4)": ((1, 4), 16, 2, None, [4, 1]),
    "16 heads, 2 kv heads, window 5, (1, 4)": ((1, 4), 16, 2, 5, [4, 1]),
    "12 heads, 2 kv heads, (1, 4)": ((1, 4), 12, 2, None, [3, 1]),
    # kv heads that divide the mesh dim are sharded with q's, as before
    "8 heads, 2 kv heads, (2, 2)": ((2, 2), 8, 2, None, [4, 1]),
    "24 heads, 4 kv heads, (1, 4)": ((1, 4), 24, 4, None, [6, 1]),
    # a rank's 3 query heads straddle the 4-head kv groups: q is gathered
    "12 heads, 3 kv heads, (1, 4)": ((1, 4), 12, 3, None, [12, 3]),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("call_flash_ranks")
    (work / "meta.json").write_text(json.dumps({"cases": {
        name: {"mesh": mesh, "heads": H, "kv_heads": KV, "window": window, "seed": i}
        for i, (name, (mesh, H, KV, window, _)) in enumerate(CASES.items())},
        "limit_s": LIMIT_S}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_call_flash_worker.py"),
                             str(work)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"the ranks did not finish within {LIMIT_S} s:\n{log[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, log[-6000:]
    return json.loads((work / "results.json").read_text())


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_attention_equals_the_plain_version(ranks, name):
    errs = ranks[name]["errs"]
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_attends_its_own_query_heads_with_the_kv_heads_they_read(ranks, name):
    (n_data, n_model), H, _, _, local = CASES[name]
    assert ranks[name]["calls"] == [[local]] * 4
    # the output keeps q's head shard unless q had to be gathered
    head_shard = local[0] < H
    assert ranks[name]["out_placements"] == ["S(0)", "S(2)" if head_shard else "R"]
