from gastx_torch.eval.metrics import (auc, euclidean_losses, mpjpe, n_mpjpe,
                                      p_mpjpe, pck, weighted_mpjpe)
from gastx_torch.eval.protocol import evaluate_sequences, run_evaluation

__all__ = ["auc", "euclidean_losses", "mpjpe", "n_mpjpe", "p_mpjpe", "pck",
           "weighted_mpjpe", "evaluate_sequences", "run_evaluation"]
