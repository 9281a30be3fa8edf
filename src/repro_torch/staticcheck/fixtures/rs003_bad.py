"""RS003 must-fail fixture: truthiness on int-or-None config fields.

The ``max_k=0`` bug class: ``max_k or n`` coerces the valid value 0
into "unbounded".  Never imported — the gate lints it and must
report RS003.
"""


def plan_levels(config, n_items: int) -> int:
    kmax = config.max_k or n_items          # 0 silently becomes unbounded
    if not config.cand_chunk:               # 0 is a valid chunk override
        kmax = min(kmax, 2)
    return kmax
