"""Small sizes of each cell for runs on the CPU (the plain versions of the kernels)."""

GEN = {"traffic": {"batch": 8, "chunk": 16, "noise_bank_rows": 8, "check_batches": 1, "trace_seconds": 0.3}}
TRAIN = {"config": {"pools": {"positive": 300, "adversarial": 300, "negative": 1000, "validation_positive": 64,
                              "validation_negative": 128},
                    "batch": {"positive": 4, "adversarial": 4, "negative": 124, "validation_positive": 4,
                              "validation_negative": 32}},
         "traffic": {"stage_steps": 40, "validation_steps": 10, "check_window_steps": [0, 20], "check_cap": 8,
                     "trace_seconds": 0.3}}
LISTEN = {"traffic": {"stream_seconds": 8, "check_chunks": 48, "trace_seconds": 0.3}}
SMALL = {"gen-fused.v8-mlp": GEN, "train.v8-transformer": TRAIN, "listen.v8-mlp": LISTEN}
# the bf16 mel's control needs a sample of some tens of augmented clips: its
# gap shows in their quietest mel bins
MEL_CONTROL = {"gen-fused.v8-mlp": {"traffic": dict(GEN["traffic"], batch=32, chunk=64, check_batches=2)},
               "listen.v8-mlp": LISTEN}
