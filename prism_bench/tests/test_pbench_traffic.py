"""The traffic generator: the same work for every seed and process."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from pbench import traffic
from pbench.tokens import TaskTokens

ROOT = Path(__file__).resolve().parents[1]

DIGEST = """
import hashlib, sys
sys.path.insert(0, {root!r})
from pbench import traffic
from pathlib import Path
h = hashlib.sha256()
for name in ("chat", "docs"):
    mix = traffic.load_mix(Path({root!r}), name)
    mix["documents"] = 12
    for q in traffic.build(mix, 2**33 + 7, 32000, 30.0):
        h.update(repr((q.due, q.origin, q.task, q.max_new)).encode())
        h.update(q.prompt.tobytes())
print(h.hexdigest())
"""


def test_traffic_is_the_same_in_every_process():
    code = DIGEST.format(root=str(ROOT))
    outs = set()
    for salt in ("0", "1", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=salt)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True)
        outs.add(out.stdout.strip())
    assert len(outs) == 1


def test_every_seed_serves_the_same_sizes_at_the_same_times():
    mix = traffic.load_mix(ROOT, "chat")
    a = traffic.build(mix, 1, 32000, 60.0)
    b = traffic.build(mix, 2**31 + 3, 32000, 60.0)
    assert [(q.due, q.origin, q.task, len(q.prompt), q.max_new) for q in a] \
        == [(q.due, q.origin, q.task, len(q.prompt), q.max_new) for q in b]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    # a longer schedule starts with the shorter one
    c = traffic.build(mix, 1, 32000, 90.0)
    assert [q.due for q in c[:len(a)]] == [q.due for q in a]


def test_chat_shapes_follow_the_mix():
    mix = traffic.load_mix(ROOT, "chat")
    reqs = traffic.build(mix, 3, 32000, 400.0)
    n_sys = mix["system_prompt_tokens"]
    lo, hi = mix["prompt_len"][2:]
    olo, ohi = mix["output_len"][2:]
    assert all(lo <= len(q.prompt) <= hi and olo <= q.max_new <= ohi
               for q in reqs)
    # each origin's prompts open with its own system prompt
    for o in range(mix["origins"]):
        heads = {q.prompt[:n_sys].tobytes() for q in reqs if q.origin == o}
        assert len(heads) == 1
    counts = np.bincount([q.origin for q in reqs], minlength=3)
    assert counts[0] > counts[1] > counts[2]  # Zipf skew 1.0
    own = np.mean([q.task == q.origin for q in reqs])
    assert 0.7 < own < 0.9
    rate = len(reqs) / 400.0
    assert abs(rate - mix["rate_per_s"]) < 0.25 * mix["rate_per_s"]


def test_docs_asks_reuse_their_document():
    mix = dict(traffic.load_mix(ROOT, "docs"), documents=30)
    reqs = traffic.build(mix, 5, 32000, 0.0)
    assert len(reqs) == 30 * mix["asks_per_doc"]
    assert all(q.due == 0.0 for q in reqs)
    by_doc: dict = {}
    for i, q in enumerate(reqs):
        by_doc.setdefault(q.doc, []).append((i, q))
    for asks in by_doc.values():
        assert len(asks) == mix["asks_per_doc"]
        qlo = mix["question_len"][0]
        n = min(len(q.prompt) for _, q in asks) - mix["question_len"][1]
        assert len({q.prompt[:n].tobytes() for _, q in asks}) == 1
        assert len({q.prompt[n + qlo:].tobytes() for _, q in asks}) > 1
        assert len({q.origin for _, q in asks}) == 1
        assert all(b[0] > a[0] for a, b in zip(asks, asks[1:]))


def test_task_tokens_are_vectorised_and_follow_successors():
    tt = TaskTokens("task0", 512, 9, bigram=1.0)
    rng = np.random.default_rng(0)
    x = tt.sample(rng, 2000)
    assert x.dtype == np.int32 and x.shape == (2000,)
    # with bigram 1.0 every token after the first is a successor
    assert all(x[i] in tt.succ[x[i - 1]] for i in range(1, 2000))
    a = TaskTokens("task1", 512, 9).sample(np.random.default_rng(1), 4000)
    b = TaskTokens("task2", 512, 9).sample(np.random.default_rng(1), 4000)
    top_a = set(np.argsort(np.bincount(a, minlength=512))[-20:])
    top_b = set(np.argsort(np.bincount(b, minlength=512))[-20:])
    assert len(top_a & top_b) < 10  # tasks use different tokens


def test_mix_files_load_and_extend():
    phi = traffic.load_mix(ROOT, "chat.phi35moe")
    chat = traffic.load_mix(ROOT, "chat")
    assert phi["prompt_len"] == chat["prompt_len"]
    assert phi["name"] == "chat.phi35moe"
    assert phi["rate_per_s"] <= 0.8 * phi["knee_per_s"] + 1e-9
