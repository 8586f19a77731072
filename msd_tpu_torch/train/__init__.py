"""Draft distillation: training records, the draft loss and optimizer, and
the epoch trainer."""
