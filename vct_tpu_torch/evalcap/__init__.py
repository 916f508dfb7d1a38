from vct_tpu_torch.evalcap.scorer import COCOScorer, make_coco_sample  # noqa: F401
