from posetpu_torch.pseudo.labeler import (
    mint_pseudo_labels,
    pareto_select,
    pckh_weighted,
    visibility_stats,
)

__all__ = [
    "mint_pseudo_labels",
    "pareto_select",
    "pckh_weighted",
    "visibility_stats",
]
