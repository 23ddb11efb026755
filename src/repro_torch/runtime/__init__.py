"""Host-side runtime policies: the retry ladder, shard health, the
straggler watchdog (:mod:`repro_torch.runtime.fault_tolerance`)."""
