"""The PQ head's decode loop on the other families against the JAX
package's: recurrentgemma-9b, mamba2-780m and qwen2-moe-a2.7b smokes at
``dtype="float32"``.  The reference's ``greedy_generate(use_pq_head=True)``
builds its PQ head from ``lm_head``; that head, carried across through
``interchange.hybrid_head_from_numpy`` (``ref`` backend), serves a loop
through ``ServeSession.next_token`` on the same params, which must return
the reference's tokens."""

import numpy as np
import pytest
import torch

from _torch_lm_helpers import port, reference_generate
from repro_torch.interchange import hybrid_head_from_numpy
from repro_torch.serve import HybridLMHead, ServeSession, serving

STEPS, MAX_LEN = 6, 48


@pytest.fixture(scope="module", params=["recurrentgemma-9b-smoke",
                                        "mamba2-780m-smoke",
                                        "qwen2-moe-a2.7b-smoke"])
def ref(request):
    return reference_generate(request.param, STEPS, MAX_LEN, pq=True)


def test_session_loop_with_carried_pq_head_equals_reference(ref):
    """prefill, the prompt's last hidden state, then decode_step +
    next_token through a session holding the reference's PQ head: the loop
    a server runs, spelled out."""
    m, p = port(ref["arch"], ref["params"])
    sess = ServeSession(
        model=m, params=p, max_len=MAX_LEN,
        pq_head=HybridLMHead(m.cfg, backend="ref"),
        pq_params=hybrid_head_from_numpy(ref["head"], codes_packed=False,
                                         device="cpu"))
    prompt = torch.from_numpy(ref["prompt"]).long()
    _, state = sess.prefill({"tokens": prompt})
    counts = torch.zeros((prompt.shape[0], m.cfg.vocab_size))
    serving._bump(counts, prompt)
    hidden, _ = m.forward(sess.params, {"tokens": prompt},
                          return_hidden=True)
    tok = sess.next_token(hidden[:, -1], counts)
    out = [tok]
    for _ in range(STEPS - 1):
        serving._bump(counts, tok[:, None])
        hidden, state = m.decode_step(sess.params, state, tok,
                                      return_hidden=True)
        tok = sess.next_token(hidden, counts)
        out.append(tok)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                  ref["tokens"])
