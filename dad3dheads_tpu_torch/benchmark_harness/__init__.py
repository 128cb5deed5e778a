from .evaluate import (
    DADEvaluator,
    HeadAnnotation,
    evaluate,
    one_sided_chamfer_mins,
    print_evaluation_results,
    print_evaluation_summary,
    procrustes,
    procrustes_batched,
    zn_accuracy,
)
from .generate_gt import generate_gt
from .submission import generate_submission, predictions_to_submission_entry

__all__ = [
    "DADEvaluator",
    "HeadAnnotation",
    "evaluate",
    "generate_gt",
    "generate_submission",
    "one_sided_chamfer_mins",
    "predictions_to_submission_entry",
    "print_evaluation_results",
    "print_evaluation_summary",
    "procrustes",
    "procrustes_batched",
    "zn_accuracy",
]
