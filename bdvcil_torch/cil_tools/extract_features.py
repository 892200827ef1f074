"""Extract the features of a dataset with a checkpoint (the counterpart of cil_tools/extract_features.py): not ported yet, ROADMAP A.7."""

from . import deferred_tool

main = deferred_tool("extract_features")

if __name__ == "__main__":
    main()
