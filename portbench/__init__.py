"""The benchmark of the PyTorch and CUDA port (``pano360_tpu_torch``):
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``README.md`` beside this file."""
