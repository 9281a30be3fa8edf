"""repro_torch.examples — the reference's mining examples on the port, run
as modules (the top-level ``examples/`` are the reference's):

    PYTHONPATH=src python -m repro_torch.examples.quickstart --compare-apriori
    PYTHONPATH=src python -m repro_torch.examples.stream_topk
    PYTHONPATH=src python -m repro_torch.examples.mine_distributed --ranks 4 \
        --dist-backend gloo

Each runs on the card unless ``--device cpu`` is given, and prints the
reference example's lines.
"""
