"""Training substrates (port of ``repro.train``): the explicit AdamW of
:mod:`repro_torch.train.optimizer` and the paper's ECG hardware-in-the-loop
accuracy loop (:mod:`repro_torch.train.ecg_accuracy`)."""
