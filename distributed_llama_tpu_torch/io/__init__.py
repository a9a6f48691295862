""".bin model reader/writer and the tokenizer."""
