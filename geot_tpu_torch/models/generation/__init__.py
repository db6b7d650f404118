"""The generation stack of the pretraining stage
(``geot_tpu/models/generation/``)."""
