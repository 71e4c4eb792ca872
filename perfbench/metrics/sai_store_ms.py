"""Mean ``sai/store`` span in ms: the store stage (dedup claims, replica
puts, the block-map commit) per write."""


def read(run):
    return run.mean_span_ms("sai/store")
