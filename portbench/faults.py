"""Faults planted in the timed path underneath a run, to show that the check
catches them: ``plant(monkeypatch_like, solver, fault)``.

``solver`` is the mix's solver (``dsgd``, ``als``) or ``online``; the
faults, each patched into the program's modules where the route the run
takes looks it up (the card's and the CPU's alike):

- ``unchanged``: the training step returns its state unchanged;
- ``half``: half of every minibatch's ratings left out (weight 0; for ALS
  half of each row's ratings left out of its gram), the update taken over
  the rest;
- ``altered``: one row of the trained table altered where it is produced.

For serving (``serve``), which holds no state that a step could leave
unchanged, ``half`` leaves out half of the users of every scored chunk
(their query rows zeroed) and ``altered`` alters one answer where it is
produced (the first user's best score of every chunk, by ``ALTER``).

The exchange between chips is not among them: every cell runs on one
card. ``patch`` is anything with ``setattr(obj, name, value)`` that undoes
itself (pytest's ``monkeypatch``, or ``Patch`` below).
"""

from __future__ import annotations

FAULTS = ("unchanged", "half", "altered")
# the faults each solver's cells can have
FAULTS_OF = {"dsgd": FAULTS, "als": FAULTS, "online": FAULTS,
             "serve": ("half", "altered")}
ALTER = 0.05  # added to one row: far above every limit, far below a NaN


class Patch:
    """A minimal undoable ``setattr``, for use outside pytest."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def _alter(table):
    table = table.clone()
    table[table.shape[0] // 2] += ALTER
    return table


def _sgd(patch, name, fault, weights_at):
    """The SGD training call ``name`` of ``ops.sgd``: the weights are its
    argument ``weights_at``."""
    from large_scale_recommendation_tpu_torch.ops import sgd

    orig = getattr(sgd, name)

    def unchanged(U, V, *a, **k):
        return U.clone(), V.clone()

    def half(*a, **k):
        a = list(a)
        w = a[weights_at].clone()
        w.view(-1)[1::2] = 0.0
        a[weights_at] = w
        return orig(*a, **k)

    def altered(*a, **k):
        U, V = orig(*a, **k)
        return _alter(U), V

    patch.setattr(sgd, name, {"unchanged": unchanged, "half": half,
                              "altered": altered}[fault])


def _dsgd_card(patch, fault):
    from large_scale_recommendation_tpu_torch.ops import cuda_sgd

    if fault == "half":
        orig_plan = cuda_sgd.build_step_plan

        def plan(su, si, sv, sw, *a, **k):
            sw = sw.clone()
            sw.view(-1)[1::2] = 0.0
            return orig_plan(su, si, sv, sw, *a, **k)

        patch.setattr(cuda_sgd, "build_step_plan", plan)
        return
    orig = cuda_sgd.dsgd_train_cuda

    def train(U, V, *a, **k):
        if fault == "unchanged":
            return U.clone(), V.clone()
        U, V = orig(U, V, *a, **k)
        return _alter(U), V

    patch.setattr(cuda_sgd, "dsgd_train_cuda", train)


def _als(patch, fault):
    import torch
    from large_scale_recommendation_tpu_torch.ops import als

    if fault == "unchanged":
        def rounds(V, prep_u, prep_v, num_u, *a, **k):
            return (torch.zeros((num_u, V.shape[1]), device=V.device),
                    V.clone())

        patch.setattr(als, "als_rounds", rounds)
    elif fault == "half":
        orig = als._gram_chunk

        def gram(factors, oi, va, wi, G=None):
            wi, va = wi.clone(), va.clone()
            wi[:, 1::2] = 0.0
            va[:, 1::2] = 0.0
            return orig(factors, oi, va, wi, G)

        patch.setattr(als, "_gram_chunk", gram)
    else:
        orig = als.solve_side

        def solve(*a, **k):
            return _alter(orig(*a, **k))

        patch.setattr(als, "solve_side", solve)


def _serve(patch, fault):
    from large_scale_recommendation_tpu_torch.serving import engine

    orig = engine.topk_step

    def half(U_chunk, *a, **k):
        U_chunk = U_chunk.clone()
        U_chunk[1::2] = 0.0
        return orig(U_chunk, *a, **k)

    def altered(*a, **k):
        vals, rows = orig(*a, **k)
        vals = vals.clone()
        vals[0, 0] += ALTER
        return vals, rows

    patch.setattr(engine, "topk_step",
                  {"half": half, "altered": altered}[fault])


def plant(patch, solver: str, fault: str) -> None:
    if fault not in FAULTS_OF.get(solver, ()):
        raise ValueError(f"no fault {fault!r} for {solver!r}")
    if solver == "dsgd":
        _sgd(patch, "dsgd_train", fault, weights_at=5)
        _dsgd_card(patch, fault)
    elif solver == "online":
        _sgd(patch, "online_train", fault, weights_at=5)
    elif solver == "als":
        _als(patch, fault)
    else:
        _serve(patch, fault)
