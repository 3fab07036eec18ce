"""The benchmark of karpenter_tpu_torch: see run.py and harness.py."""
