"""Flat metric-name -> float logging dicts.

The port's own copy of ``ikea_recommender_tpu/utils/logging_dicts.py``, over
the port's ``EvalResult``. Key names match the reference exactly
(``utils/logging_SMORL.py:1-127``) so dashboards and the
``best_model_metric`` config value ("Val_NDCG@12", ...) carry over
unchanged. The ``prefix`` argument implements the double-Q second-network
logging (``Sec_`` prefix, val-only keys).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ikea_recommender_tpu_torch.eval.protocol import EvalResult


def get_logging_dict_train(
    train_sup_loss: float,
    train_q_loss: Optional[float],
    train_res: EvalResult,
    val_res: EvalResult,
    topk_hr_ndcg: Sequence[int],
    topk_cov: Sequence[int],
    q_included: bool = True,
    prefix: str = "",
) -> Dict[str, float]:
    d: Dict[str, float] = {}
    d["Supervised Train Loss"] = float(train_sup_loss)
    if q_included:
        d["Q-Modification-Signal"] = float(train_q_loss)
    d[f"{prefix+' '}Supervised Val Loss"] = float(val_res.loss)

    for i, k in enumerate(topk_hr_ndcg):
        d[f"Train_HR@{k}"] = float(train_res.hr[i])
        d[f"Train_NDCG@{k}"] = float(train_res.ndcg[i])
        d[f"{prefix}Val_HR@{k}"] = float(val_res.hr[i])
        d[f"{prefix}Val_NDCG@{k}"] = float(val_res.ndcg[i])
        d[f"{prefix}Train_R@{k}"] = float(train_res.reps[i])
        d[f"{prefix}Val_R@{k}"] = float(val_res.reps[i])

    for k in topk_cov:
        d[f"Train_NOV_CV@{k}"] = float(train_res.coverage[k][0])
        d[f"Train_DIV_CV@{k}"] = float(train_res.coverage[k][1])
        d[f"{prefix}Val_NOV_CV@{k}"] = float(val_res.coverage[k][0])
        d[f"{prefix}Val_DIV_CV@{k}"] = float(val_res.coverage[k][1])

    d["Train_Nov_Reward"] = float(train_res.nov_rew)
    d["Train_Div_Reward"] = float(train_res.div_rew)
    d[f"{prefix}Val_Nov_Reward"] = float(val_res.nov_rew)
    d[f"{prefix}Val_Div_Reward"] = float(val_res.div_rew)

    # Second-net logging keeps only Val metrics (logging_SMORL.py:69-74).
    if prefix != "":
        d = {k: v for k, v in d.items() if "Val" in k}
    return d


def get_logging_dict_by_type(
    res: EvalResult,
    topk_hr_ndcg: Sequence[int],
    name: str,
    prefix: str = "",
) -> Dict[str, float]:
    """Per-action-type HR/NDCG keys in the old generation's format
    (``old/logging_old.py:1-19``): ``{name}_HR@{k}[{Type}]`` for every type
    plus ``[Total]`` (= the standard all-samples HR/NDCG)."""
    d: Dict[str, float] = {}
    if not res.by_type:
        return d
    for i, k in enumerate(topk_hr_ndcg):
        for t_name, t_res in res.by_type.items():
            cap = t_name.capitalize()
            d[f"{prefix}{name}_HR@{k}[{cap}]"] = float(t_res["hr"][i])
            d[f"{prefix}{name}_NDCG@{k}[{cap}]"] = float(t_res["ndcg"][i])
        d[f"{prefix}{name}_HR@{k}[Total]"] = float(res.hr[i])
        d[f"{prefix}{name}_NDCG@{k}[Total]"] = float(res.ndcg[i])
    return d


def get_logging_dict_test(
    test_res: EvalResult,
    topk_hr_ndcg: Sequence[int],
    topk_cov: Sequence[int],
    real_test: bool = False,
    prefix: str = "",
    name: Optional[str] = None,
) -> Dict[str, float]:
    name = name or ("Test" if real_test else "Best_Val")
    d: Dict[str, float] = {f"{prefix}{name} Loss": float(test_res.loss)}
    for i, k in enumerate(topk_hr_ndcg):
        d[f"{prefix}{name}_HR@{k}"] = float(test_res.hr[i])
        d[f"{prefix}{name}_NDCG@{k}"] = float(test_res.ndcg[i])
        d[f"{prefix}Val_R@{k}"] = float(test_res.reps[i])
    for k in topk_cov:
        d[f"{prefix}{name}_NOV_CV@{k}"] = float(test_res.coverage[k][0])
        d[f"{prefix}{name}_DIV_CV@{k}"] = float(test_res.coverage[k][1])
    d[f"{prefix}{name}_Nov_Reward"] = float(test_res.nov_rew)
    d[f"{prefix}{name}_Div_Reward"] = float(test_res.div_rew)
    return d
