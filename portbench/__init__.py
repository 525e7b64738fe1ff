"""The benchmark of the PyTorch/CUDA port (``multiview_stitcher_torch``).

Run a cell with ``python3 portbench/run.py``; ``README.md`` says how the
harness finds configurations, traffic, job kinds and metric readers by name.
"""
