"""Draft-model-free speculative drafting: n-gram prompt lookup.

The drafter proposes up to ``k`` future tokens for a slot by matching
the slot's most recent n-gram against its own history (prompt +
everything generated so far) and replaying what followed the previous
occurrence — "prompt lookup decoding".  There is no draft model, no
extra parameters and no device work: proposals are pure host-side
bookkeeping over an int list, and a wrong proposal costs only the
wasted verify FLOPs (greedy acceptance keeps the output stream
token-identical to one-token decode regardless of draft quality).

This pays off exactly when the continuation is predictable from the
context — repetitive prompts (the Markov ``SyntheticTokens`` walks),
code/boilerplate completion, or greedy decode settling into a cycle —
which is the serving-side analogue of the paper's thesis: spend the
same hardware step on more useful work when the workload allows it.
"""
from __future__ import annotations

from typing import List, Sequence


def propose_ngram(history: Sequence[int], k: int,
                  max_ngram: int = 3) -> List[int]:
    """Propose up to ``k`` draft tokens continuing ``history``.

    Tries the longest suffix n-gram first (``max_ngram`` down to 1),
    scanning for that n-gram's most recent *earlier* occurrence; on a
    hit, the tokens that followed it are the proposal.  Returns ``[]``
    when nothing matches (the engine then falls back to plain one-token
    decode for the tick — speculation never blocks).
    """
    h = list(history)
    if k <= 0 or len(h) < 2:
        return []
    for n in range(min(max_ngram, len(h) - 1), 0, -1):
        pat = h[-n:]
        # latest occurrence strictly before the suffix itself
        for j in range(len(h) - n - 1, -1, -1):
            if h[j:j + n] == pat:
                out = h[j + n:j + n + k]
                if out:
                    return out
                break                       # shorter n-gram may still hit
    return []


def accepted_prefix_len(drafts: Sequence[int],
                        verified: Sequence[int]) -> int:
    """Greedy acceptance: length of the longest draft prefix matching the
    verify step's (greedy) token at the same position.  ``verified[j]``
    is the model's token *after* consuming draft ``j-1`` (``verified[0]``
    follows the pending token), so draft ``j`` is accepted iff it equals
    ``verified[j]`` — bit-exact speculative decoding by construction.
    """
    a = 0
    for d, v in zip(drafts, verified):
        if int(d) != int(v):
            break
        a += 1
    return a
