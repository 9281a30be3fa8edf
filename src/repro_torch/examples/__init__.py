"""repro_torch.examples — the reference's examples on the port, run as
modules (the top-level ``examples/`` are the reference's):

    PYTHONPATH=src python -m repro_torch.examples.quickstart --compare-apriori
    PYTHONPATH=src python -m repro_torch.examples.stream_topk
    PYTHONPATH=src python -m repro_torch.examples.mine_distributed --ranks 4 \
        --dist-backend gloo
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 60
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 12

Each runs on the card unless ``--device cpu`` is given, and prints the
reference example's lines.
"""
