"""The paper-table drivers on ``repro_torch.sim`` (ports of the repo-root
``benchmarks/`` modules): ``table1`` (model sizes), ``table2``
(communication cost), ``fig1`` (accuracy under sparsification) and ``fig3``
(THGS vs flat sparsification). Each ``run(quick, device)`` returns the
reference's ``(name, us_per_call, derived)`` rows; ``python -m
repro_torch.bench --csv --only table1,table2,fig1,fig3`` prints them."""
