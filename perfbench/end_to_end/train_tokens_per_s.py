"""train_tokens_per_s: the tokens of every step completed in the window,
each step ending in a synchronise, over the window (which closes at the
end of its last step)."""


def read(record):
    return record["steps"] * record["tokens_per_step"] / record["window_s"]
