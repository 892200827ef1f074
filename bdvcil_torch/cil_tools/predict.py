"""Predict the classes of videos with a trained checkpoint (the counterpart of cil_tools/predict.py): not ported yet, ROADMAP A.7."""

from . import deferred_tool

main = deferred_tool("predict")

if __name__ == "__main__":
    main()
