from repro_torch.data.pipeline import ByteTokenizer, SyntheticCorpus, make_batches
