"""The Instacart pipeline's entry points, each run as a module
(`python -m two_tower_recommender_model_tpu_torch.cli.<name>`) and each with
a `main(argv=None)` that returns its results as a dict:

- `fetch_instacart`     the schema-faithful replica CSVs;
- `prepare_instacart`   CSVs -> TTRS train/val/test shards, `meta.json`,
                        `id_mappings.npz`;
- `train`               the single-device training run, with export;
- `evaluate_retrieval`  recall@k of an exported model on a split;
- `instacart_pipeline`  the four in one process.

The stages that touch the model (`train`, `evaluate_retrieval`,
`instacart_pipeline`) run on the card unless given `--device cpu`.
"""
