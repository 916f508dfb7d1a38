from vct_tpu_torch.text.tokenizer import WordPieceTokenizer, CaptionPreprocessor  # noqa: F401
