"""`python -m ogmm_tpu_torch.train ...`: the training command line
(ogmm_tpu_torch/train/cli.py)."""
from ogmm_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
