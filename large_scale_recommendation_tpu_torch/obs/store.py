"""STORE observability plane: the tiered factor store's live surface
(counterpart of ``large_scale_recommendation_tpu.obs.store``; no framework
code, the same module).

Module-default ``None`` like every other optional plane: ``get_store()``
answers ``None`` until a ``store.tiered.TieredFactorStore`` installs itself
at construction (latest wins — the common deployment has one user store),
and every consumer pays one ``is not None`` test. ``obs.disable()`` resets
it with the rest.

The store's registry gauges (``tier_hit_rate``, ``tier_prefetch_wait_s``,
``tier_evictions_total``, ``tier_host_bytes``) bind at the store's
construction behind the registry's ``enabled`` flag — the shared null
instrument when obs is disabled. This module is only the addressing layer:
who the current store is, and the ``/storez`` body.
"""

from __future__ import annotations

_STORE = None


def get_store():
    """The currently installed tiered store, or ``None``."""
    return _STORE


def set_store(store) -> None:
    """Install ``store`` as the process's STORE plane (``None`` to clear).
    Called by ``TieredFactorStore.__init__`` — latest wins."""
    global _STORE
    _STORE = store


def storez() -> dict:
    """The ``/storez`` endpoint body: the installed store's snapshot, or
    the absent-plane note."""
    store = get_store()
    if store is None:
        return {"note": "no tiered store installed "
                        "(store.TieredFactorStore)", "tiers": {}}
    return store.snapshot()
