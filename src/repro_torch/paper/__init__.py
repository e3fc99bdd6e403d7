"""The paper's experiments (§IV) on the port: Table 2, Figs. 1–4, the
DDRF ablation, the communication-cost claim and the convergence curve,
each a ``run`` that prints the JAX package's CSV rows.

* common.py            — the protocol: split, c selection, the runners
* table2.py            — DKLA / DKLA-DDRF / DeKRR-DDRF on six datasets
* fig1_noniid_y.py     — RSE vs D̄, non-IID by |y|
* fig2_noniid_xnorm.py — RSE vs D̄, non-IID by ‖x‖₂
* fig3_imbalanced.py   — equal vs √N_j-proportional D_j
* fig4_pernode.py      — per-node RSE under the imbalanced split
* ablation_ddrf.py     — the selection rule: plain, energy, leverage
* comm_costs.py        — matched-error D and the cost of a round
* convergence_curve.py — objective descent and spectral radius

Command line: ``python -m repro_torch.paper {table2,fig1,fig2,fig3,fig4,
ablation,comm,convergence,all} [--fast] [--subsample N|full]
[--device cpu]``, on the card unless told otherwise.
"""
