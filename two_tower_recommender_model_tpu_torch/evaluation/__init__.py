from two_tower_recommender_model_tpu_torch.evaluation.retrieval import (  # noqa: F401
    evaluate_retrieval,
    export_feature_embeddings,
    make_retrieval_eval_fn,
    per_user_retrieval_table,
    retrieval_metrics,
    split_positives,
)
