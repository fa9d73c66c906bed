from repro_torch.train.optim import AdamWState, adamw_init, adamw_update, train_step
