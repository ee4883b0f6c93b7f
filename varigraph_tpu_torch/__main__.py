from .cli import run as main

if __name__ == "__main__":
    import sys

    sys.exit(main())
