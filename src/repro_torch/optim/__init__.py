"""The reference's optimiser (``optim/``) on tensors: learning-rate
schedules, AdamW with global-norm clipping, and int8 error-feedback
gradient compression, as plain functions over parameter trees in
float32."""
